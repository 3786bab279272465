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
// tensor's column ranges (PackedBwdLoader), from the row log-sum-exp that
// the forward writes when asked (`lse`).
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

// The backward's loader (attention_bwd_sm90.cuh): maps over the packed
// columns, as the forward's, with the boxes the two kernels load (64 query
// rows, 128 keys), and over d`qkv`, whose column ranges take dq, dk, dv.
template <int D>
struct PackedBwdLoader {
  static constexpr int kHeadDim = D;
  CUtensorMap q;          // qkv as (3W, Npad, B), box 64 rows
  CUtensorMap kv;         // qkv as (3W, n_real, B), box 128 rows: rows >= n_real read as zeros
  CUtensorMap dout, out;  // (W, Npad, B), box 64 rows
  CUtensorMap dqkv;       // (3W, Npad, B), box 64 rows
  const float* lse;       // (B, H, Npad), the forward's
  float* l2s;             // (B, H, rows_pad) scratch: LSE in log2 units
  float* dls;             // (B, H, rows_pad) scratch: D
  int n_keys;             // n_real
  int n_rows;             // Npad
  int n_kv_rows;          // Npad
  int rows_pad;           // Npad rounded up to 64
  int w;
  float scale;

  __device__ const int* key_ids(int) const { return nullptr; }
  __device__ void prefetch() const {
    prefetch_map(&q);
    prefetch_map(&kv);
    prefetch_map(&dout);
    prefetch_map(&out);
  }
  __device__ void load_q(uint32_t dst, uint32_t bar, int r0, int h, int b) const {
    tma_load_3d(dst, &q, bar, h * D, r0, b);
  }
  __device__ void load_do(uint32_t dst, uint32_t bar, int r0, int h, int b) const {
    tma_load_3d(dst, &dout, bar, h * D, r0, b);
  }
  __device__ void load_o(uint32_t dst, uint32_t bar, int r0, int h, int b) const {
    tma_load_3d(dst, &out, bar, h * D, r0, b);
  }
  __device__ void load_k(uint32_t dst, uint32_t bar, int r0, int h, int b) const {
    tma_load_3d(dst, &kv, bar, w + h * D, r0, b);
  }
  __device__ void load_v(uint32_t dst, uint32_t bar, int r0, int h, int b) const {
    tma_load_3d(dst, &kv, bar, 2 * w + h * D, r0, b);
  }
  __device__ void store_dq(uint32_t src, int r0, int h, int b) const {
    tma_store_3d(&dqkv, src, h * D, r0, b);
  }
  __device__ void store_dk(uint32_t src, int r0, int h, int b) const {
    tma_store_3d(&dqkv, src, w + h * D, r0, b);
  }
  __device__ void store_dv(uint32_t src, int r0, int h, int b) const {
    tma_store_3d(&dqkv, src, 2 * w + h * D, r0, b);
  }
};

// in: qkv, out, dout.
template <int D>
int run_bwd(const void* const (&in)[3], const void* lse, void* lse_rows, void* delta_rows,
            void* dqkv, int batch, int n_pad, int num_heads, int n_real, float scale,
            cudaStream_t stream) {
  const int w = num_heads * D;
  PackedBwdLoader<D> ld;
  const cuuint64_t row = 3ull * w * 2;
  const cuuint64_t qkv_strides[2] = {row, row * n_pad};
  const cuuint64_t out_strides[2] = {2ull * w, 2ull * w * n_pad};
  const cuuint32_t q_box[3] = {D, attn_bwd::kQTile, 1};
  const cuuint32_t kv_box[3] = {D, attn_bwd::kKTile, 1};
  const cuuint64_t qkv_dims[3] = {3ull * w, static_cast<cuuint64_t>(n_pad),
                                  static_cast<cuuint64_t>(batch)};
  const cuuint64_t kv_dims[3] = {3ull * w, static_cast<cuuint64_t>(n_real),
                                 static_cast<cuuint64_t>(batch)};
  const cuuint64_t out_dims[3] = {static_cast<cuuint64_t>(w), static_cast<cuuint64_t>(n_pad),
                                  static_cast<cuuint64_t>(batch)};
  int err = encode_map(&ld.q, in[0], 3, qkv_dims, qkv_strides, q_box, kSwizzle<D>);
  if (err == 0) err = encode_map(&ld.kv, in[0], 3, kv_dims, qkv_strides, kv_box, kSwizzle<D>);
  if (err == 0) err = encode_map(&ld.out, in[1], 3, out_dims, out_strides, q_box, kSwizzle<D>);
  if (err == 0) err = encode_map(&ld.dout, in[2], 3, out_dims, out_strides, q_box, kSwizzle<D>);
  if (err == 0) err = encode_map(&ld.dqkv, dqkv, 3, qkv_dims, qkv_strides, q_box, kSwizzle<D>);
  if (err != 0) return err;
  ld.lse = static_cast<const float*>(lse);
  ld.l2s = static_cast<float*>(lse_rows);
  ld.dls = static_cast<float*>(delta_rows);
  ld.n_keys = n_real;
  ld.n_rows = n_pad;
  ld.n_kv_rows = n_pad;
  ld.rows_pad = (n_pad + 63) / 64 * 64;
  ld.w = w;
  ld.scale = scale;
  return attn_bwd::launch_bwd(ld, num_heads, batch, stream);
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
// kernels in place (no concatenation), from the packed `qkv`, the forward's
// output `out` and the output's cotangent `dout`, both contiguous
// (B, Npad, W), and the forward's `lse` (B, H, Npad) fp32. `lse_rows` and
// `delta_rows` are (B, H, Npad rounded up to 64) fp32 scratch arrays (as for
// flash_attention_bwd). Keys >= n_real are masked, and their dK and dV rows
// are written as zeros. Returns as flash_attention_bwd does.
extern "C" int packed_attention_bwd(const void* qkv, const void* out, const void* dout,
                                    const void* lse, void* lse_rows, void* delta_rows,
                                    void* dqkv, int batch, int n_pad, int num_heads,
                                    int head_dim, int n_real, float scale, void* stream) {
  if ((head_dim != 64 && head_dim != 32) || n_real < 1 || n_real > n_pad || batch < 1 ||
      num_heads < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (const int err = attn_bwd::bind_context()) return err;
  const void* in[3] = {qkv, out, dout};
  const auto s = static_cast<cudaStream_t>(stream);
  return head_dim == 64 ? run_bwd<64>(in, lse, lse_rows, delta_rows, dqkv, batch, n_pad,
                                      num_heads, n_real, scale, s)
                        : run_bwd<32>(in, lse, lse_rows, delta_rows, dqkv, batch, n_pad,
                                      num_heads, n_real, scale, s);
}
