// Packed self-attention forward for Hopper (sm_90a), bf16 in, bf16 out.
//
// Replaces labelany3d_tpu/ops/attention.py::_packed_flash_fwd (the Pallas
// TPU kernel behind packed_flash_sdpa). It computes the same function:
// non-causal multi-head attention read straight from the packed
// (B, Npad, 3W) qkv tensor of the fused QKV projection -- q, k and v are the
// column ranges [0, W), [W, 2W) and [2W, 3W) -- with keys at index >= n_real
// masked, scale 1/sqrt(d), fp32 softmax and fp32 accumulation. Output is
// (B, Npad, W) with head h in columns [h*d, (h+1)*d); every row is written,
// pad rows included. Head dim 64 (MoGe, DepthPro, the full matcher,
// DINOv2) or 32 (the elevation matcher's tiny ViT: 2 heads of 32).
//
// Design. The TPU kernel keeps a whole key row (1408 keys) in VMEM and runs
// an exact two-pass softmax; a block's shared memory holds far less, so the
// keys stream through the online-softmax main loop of attention_sm90.cuh
// (TMA loads into an mbarrier ring, wgmma for QK^T and PV; see there). This
// file is that loop's loader for the packed layout:
//   * 3-D tensor maps over the packed tensor, so q, k and v need no split
//     or transpose pass: Q as (3W, Npad, B); K and V as (3W, n_real, B)
//     with the batch stride of Npad rows; the head's columns h*d,
//     W + h*d and 2W + h*d are TMA coordinates;
//   * because the K/V map ends at n_real, rows >= n_real arrive as zeros:
//     a NaN in a pad row can never reach a real output (the TPU kernel
//     multiplies p = 0 by whatever the pad V rows hold), and the main loop
//     sets the scores of keys >= n_real in the last tile to -inf;
//   * key tiles are ceil(n_real / 128) and query tiles ceil(Npad / 192);
//     in the last query tile, the warpgroups whose 64 rows lie past Npad
//     leave at once, and the output map (W, Npad, B) is written in 64-row
//     stores.
//
// Backward. The JAX package has no backward kernel for this one (its VJP is
// XLA's over _packed_reference); packed_attention_bwd runs the dQ and dK/dV
// kernels of attention_bwd_sm90.cuh (K2's backward) over the packed
// tensor's column ranges, from the row log-sum-exp that the forward writes
// when asked (`lse`).
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s). Every
// query row, pad rows included, is computed and written, against the n_real
// real keys: operations 4*B*H*Npad*n_real*d; bytes are Q read and the output
// written over Npad rows, K and V read over n_real rows (bf16).
//   MoGe call (B=8, Npad=1408, n_real=1297, H=16, d=64): 59.8 GFLOP
//     -> 0.060 ms against 88.6 MB -> 0.026 ms: operations.
//   DepthPro call (B=40, Npad=384, n_real=325): 20.4 GFLOP -> 0.021 ms
//     against 116.1 MB -> 0.035 ms: bytes.
//   Elevation matcher (B=2, Npad=1152, n_real=1025, H=2, d=32): 0.60 GFLOP
//     -> 0.00061 ms against 1.11 MB -> 0.00033 ms: operations, at a size
//     where the launch costs more than either.

#include "attention_bwd_sm90.cuh"
#include "attention_sm90.cuh"

namespace {

using namespace attn_sm90;

template <int D>
struct PackedLoader {
  static constexpr int kHeadDim = D;
  CUtensorMap q;    // qkv as (3W, Npad, B)
  CUtensorMap kv;   // qkv as (3W, n_real, B): rows >= n_real read as zeros
  CUtensorMap out;  // out as (W, Npad, B)
  int n_keys;       // n_real
  int n_rows;       // Npad
  int w;
  float scale_log2;
  float* lse;       // (B, H, Npad) row log-sum-exp, or null

  __device__ const int* key_ids(int) const { return nullptr; }
  __device__ void prefetch() const {
    prefetch_map(&q);
    prefetch_map(&kv);
    prefetch_map(&out);
  }
  __device__ void load_q(uint32_t dst, uint32_t bar, int q0, int h, int b) const {
    tma_load_3d(dst, &q, bar, h * D, q0, b);
  }
  __device__ void load_kv(uint32_t dk, uint32_t dv, uint32_t bar, int k0, int h, int b) const {
    tma_load_3d(dk, &kv, bar, w + h * D, k0, b);
    tma_load_3d(dv, &kv, bar, 2 * w + h * D, k0, b);
  }
  __device__ void store_o(uint32_t src, int row0, int h, int b) const {
    tma_store_3d(&out, src, h * D, row0, b);
  }
};

template <int D>
int run(const void* qkv, void* out, float* lse, int batch, int n_pad, int num_heads, int n_real,
        float scale, cudaStream_t stream) {
  const int w = num_heads * D;
  PackedLoader<D> ld;
  const cuuint64_t row = 3ull * w * 2;
  const cuuint64_t in_strides[2] = {row, row * n_pad};
  const cuuint32_t q_box[3] = {D, kBlockM, 1};
  const cuuint32_t kv_box[3] = {D, kBlockN, 1};
  const cuuint64_t q_dims[3] = {3ull * w, static_cast<cuuint64_t>(n_pad),
                                static_cast<cuuint64_t>(batch)};
  const cuuint64_t kv_dims[3] = {3ull * w, static_cast<cuuint64_t>(n_real),
                                 static_cast<cuuint64_t>(batch)};
  const cuuint64_t out_dims[3] = {static_cast<cuuint64_t>(w), static_cast<cuuint64_t>(n_pad),
                                  static_cast<cuuint64_t>(batch)};
  const cuuint64_t out_strides[2] = {2ull * w, 2ull * w * n_pad};
  const cuuint32_t out_box[3] = {D, 64, 1};  // one warpgroup's rows
  int err = encode_map(&ld.q, qkv, 3, q_dims, in_strides, q_box, kSwizzle<D>);
  if (err == 0) err = encode_map(&ld.kv, qkv, 3, kv_dims, in_strides, kv_box, kSwizzle<D>);
  if (err == 0) err = encode_map(&ld.out, out, 3, out_dims, out_strides, out_box, kSwizzle<D>);
  if (err != 0) return err;
  ld.n_keys = n_real;
  ld.n_rows = n_pad;
  ld.w = w;
  ld.scale_log2 = scale * 1.4426950408889634f;
  ld.lse = lse;
  return launch(ld, (n_pad + kBlockM - 1) / kBlockM, num_heads, batch, stream);
}

}  // namespace

// C entry point (bound with ctypes). `lse` is null or a (B, H, Npad) fp32
// array that receives each row's log-sum-exp (for the backward). Launches
// on `stream` and returns cudaGetLastError() so a refused launch is
// reported to the caller; a negative value is minus the CUresult of a
// tensor map that failed to encode.
extern "C" int packed_attention_fwd(const void* qkv, void* out, void* lse, int batch, int n_pad,
                                    int num_heads, int head_dim, int n_real, float scale,
                                    void* stream) {
  if ((head_dim != 64 && head_dim != 32) || n_pad % 64 != 0 || n_real < 1 || n_real > n_pad ||
      batch < 1 || num_heads < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return head_dim == 64 ? run<64>(qkv, out, l, batch, n_pad, num_heads, n_real, scale, st)
                        : run<32>(qkv, out, l, batch, n_pad, num_heads, n_real, scale, st);
}

// The backward (attention_bwd_sm90.cuh): d`qkv` (B, Npad, 3W) bf16, its
// column ranges [0, W), [W, 2W) and [2W, 3W) written by the dQ and the dK/dV
// kernels in place (no concatenation), from the packed `qkv`, the output's
// cotangent `dout` (B, Npad, W), the forward's `lse` and
// delta = rowsum(dout * out), both (B, H, Npad) fp32. Keys >= n_real are
// masked, and their dK and dV rows are written as zeros. Returns as
// flash_attention_bwd does.
extern "C" int packed_attention_bwd(const void* qkv, const void* dout, const void* lse,
                                    const void* delta, void* dqkv, int batch, int n_pad,
                                    int num_heads, int head_dim, int n_real, float scale,
                                    void* stream) {
  if ((head_dim != 64 && head_dim != 32) || n_real < 1 || n_real > n_pad || batch < 1 ||
      num_heads < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using attn_bwd::bf16;
  const long long w = static_cast<long long>(num_heads) * head_dim;
  const long long row = 3 * w;
  const auto* in = static_cast<const bf16*>(qkv);
  auto* out = static_cast<bf16*>(dqkv);
  attn_bwd::BwdParams p;
  p.q = {in, n_pad * row, row, head_dim};
  p.k = {in + w, n_pad * row, row, head_dim};
  p.v = {in + 2 * w, n_pad * row, row, head_dim};
  p.dout = {static_cast<const bf16*>(dout), n_pad * w, w, head_dim};
  p.dq = {out, n_pad * row, row, head_dim};
  p.dk = {out + w, n_pad * row, row, head_dim};
  p.dv = {out + 2 * w, n_pad * row, row, head_dim};
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.kv_ids = nullptr;
  p.heads = num_heads;
  p.sq = n_pad;
  p.n_keys = n_real;
  p.n_kv_rows = n_pad;
  p.scale = scale;
  const auto s = static_cast<cudaStream_t>(stream);
  return head_dim == 64 ? attn_bwd::launch_bwd<64>(p, batch, s)
                        : attn_bwd::launch_bwd<32>(p, batch, s);
}
