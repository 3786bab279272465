// Multi-head attention forward for Hopper (sm_90a) in the (B, S, H, D)
// layout, bf16 in, bf16 out.
//
// Replaces labelany3d_tpu/ops/attention.py::flash_sdpa, which wraps the
// Pallas TPU library kernel jax.experimental.pallas.ops.tpu.flash_attention.
// It computes the same function: non-causal attention of q (B, Sq, H, D)
// against k, v (B, Sk, H, D), Sq and Sk free to differ (cross attention),
// scale 1/sqrt(d), fp32 softmax and accumulation, and keys masked where an
// optional (B, Sk) int32 id array is non-zero (the segment-id pad mask).
// The output is (B, Sq, H, D), contiguous. D is 64 or 32 (the elevation
// matcher's tiny decoder: 2 heads of 32).
//
// Design. The TPU kernel holds the whole K/V block of a head in VMEM and
// pads both sequences to a multiple of 128. Neither carries over: a block
// has at most 227 KB of shared memory. The keys stream through the
// online-softmax main loop of attention_sm90.cuh (TMA loads into an
// mbarrier ring, wgmma for QK^T and PV; see there). This file is that
// loop's loader for the strided layout:
//   * 4-D tensor maps (D, H, S, B) built from the torch strides, so q, k
//     and v are read in place, transposed and broadcast views included (no
//     transpose or pad pass). Sq bounds the Q
//     map and Sk the K/V maps, so the ragged tails (1296 = 10 * 128 + 16)
//     arrive as zeros; the main loop sets the scores of keys >= Sk to -inf;
//     the output map clips rows >= Sq, which are never written;
//   * segment ids: the main loop reads each tile's ids, sets the masked
//     keys' scores to -inf and zeroes their V rows in shared memory before
//     PV (TMA brings them as they are), so a NaN in a pad row never reaches
//     an output. Fully masked rows write zeros.
//
// Backward. flash_attention_bwd is the library's custom VJP
// (_flash_attention_bwd_dkv and _flash_attention_bwd_dq, its two further
// pallas_calls): the dQ and dK/dV kernels of attention_bwd_sm90.cuh over
// the same strided operands and segment ids, from the row log-sum-exp that
// the forward writes when asked (`lse`).
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the
// matcher decoder's call, P pairs x 1296 queries x 1296 keys x 12 heads of
// 64, does 4*P*H*Sq*Sk*d operations against 2*P*(2*Sq + 2*Sk)*H*d bytes:
// 165 GFLOP (0.167 ms) against 255 MB (0.076 ms) at P = 32: operations.

#include "attention_bwd_sm90.cuh"
#include "attention_sm90.cuh"

namespace {

using namespace attn_sm90;

template <int D>
struct StridedLoader {
  static constexpr int kHeadDim = D;
  CUtensorMap q, k, v;  // (D, H, S, B) through the torch strides
  CUtensorMap out;      // (D, H, Sq, B), contiguous
  const int* ids;       // (B, Sk), 0 = real key; or null
  int n_keys;           // Sk
  int n_rows;           // Sq
  float scale_log2;
  float* lse;           // (B, H, Sq) row log-sum-exp, or null

  __device__ const int* key_ids(int b) const {
    return ids == nullptr ? nullptr : ids + static_cast<long long>(b) * n_keys;
  }
  __device__ void prefetch() const {
    prefetch_map(&q);
    prefetch_map(&k);
    prefetch_map(&v);
    prefetch_map(&out);
  }
  __device__ void load_q(uint32_t dst, uint32_t bar, int q0, int h, int b) const {
    tma_load_4d(dst, &q, bar, 0, h, q0, b);
  }
  __device__ void load_kv(uint32_t dk, uint32_t dv, uint32_t bar, int k0, int h, int b) const {
    tma_load_4d(dk, &k, bar, 0, h, k0, b);
    tma_load_4d(dv, &v, bar, 0, h, k0, b);
  }
  __device__ void store_o(uint32_t src, int row0, int h, int b) const {
    tma_store_4d(&out, src, 0, h, row0, b);
  }
};

// The map (D, H, S, B) of one (B, S, H, D) operand with element strides
// (sb, ss, sh), read as they are: TMA takes strides in any order, and 0
// for a broadcast dimension.
template <int D>
int encode_operand(CUtensorMap* map, const void* ptr, int batch, int seq, int heads,
                   long long sb, long long ss, long long sh, int box_rows) {
  const cuuint64_t dims[4] = {D, static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(ss) * 2,
                               static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {D, 1, static_cast<cuuint32_t>(box_rows), 1};
  return encode_map(map, ptr, 4, dims, bytes, box, kSwizzle<D>);
}

template <int D>
int run(const void* q, const void* k, const void* v, void* out, const void* kv_ids, float* lse,
        int batch, int sq, int sk, int num_heads, const long long (&st)[9], float scale,
        cudaStream_t stream) {
  StridedLoader<D> ld;
  const long long w = static_cast<long long>(num_heads) * D;
  int err = encode_operand<D>(&ld.q, q, batch, sq, num_heads, st[0], st[1], st[2], kBlockM);
  if (err == 0) err = encode_operand<D>(&ld.k, k, batch, sk, num_heads, st[3], st[4], st[5], kBlockN);
  if (err == 0) err = encode_operand<D>(&ld.v, v, batch, sk, num_heads, st[6], st[7], st[8], kBlockN);
  if (err == 0) {
    // One warpgroup's 64 rows a store.
    err = encode_operand<D>(&ld.out, out, batch, sq, num_heads, sq * w, w, D, 64);
  }
  if (err != 0) return err;
  ld.ids = static_cast<const int*>(kv_ids);
  ld.n_keys = sk;
  ld.n_rows = sq;
  ld.scale_log2 = scale * 1.4426950408889634f;
  ld.lse = lse;
  return launch(ld, (sq + kBlockM - 1) / kBlockM, num_heads, batch, stream);
}

}  // namespace

// C entry point (bound with ctypes). Strides are in elements; the head dim
// of q, k and v is contiguous. `kv_ids` is null or a (B, Sk) int32 array
// (0 = real key). `lse` is null or a (B, H, Sq) fp32 array that receives
// each row's log-sum-exp (for the backward). Launches on `stream` and
// returns cudaGetLastError() so a refused launch is reported to the caller;
// a negative value is minus the CUresult of a tensor map that failed to
// encode.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   const void* kv_ids, void* lse, int batch, int sq, int sk,
                                   int num_heads, int head_dim,
                                   long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss, long long v_sh,
                                   float scale, void* stream) {
  if ((head_dim != 64 && head_dim != 32) || sq < 1 || sk < 1 || batch < 1 || num_heads < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  const auto s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return head_dim == 64
             ? run<64>(q, k, v, out, kv_ids, l, batch, sq, sk, num_heads, st, scale, s)
             : run<32>(q, k, v, out, kv_ids, l, batch, sq, sk, num_heads, st, scale, s);
}

// The backward (attention_bwd_sm90.cuh): dq, dk and dv, fresh contiguous
// (B, S, H, D) bf16 arrays, from q, k, v and the output's cotangent `dout`
// read through their element strides, the forward's `lse` and
// delta = rowsum(dout * out), both (B, H, Sq) fp32, and the forward's
// `kv_ids`. Returns as the forward does.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   const void* kv_ids, void* dq, void* dk, void* dv, int batch,
                                   int sq, int sk, int num_heads, int head_dim,
                                   long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss, long long v_sh,
                                   long long do_sb, long long do_ss, long long do_sh,
                                   float scale, void* stream) {
  if ((head_dim != 64 && head_dim != 32) || sq < 1 || sk < 1 || batch < 1 || num_heads < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using attn_bwd::bf16;
  const long long w = static_cast<long long>(num_heads) * head_dim;
  attn_bwd::BwdParams p;
  p.q = {static_cast<const bf16*>(q), q_sb, q_ss, q_sh};
  p.k = {static_cast<const bf16*>(k), k_sb, k_ss, k_sh};
  p.v = {static_cast<const bf16*>(v), v_sb, v_ss, v_sh};
  p.dout = {static_cast<const bf16*>(dout), do_sb, do_ss, do_sh};
  p.dq = {static_cast<bf16*>(dq), sq * w, w, head_dim};
  p.dk = {static_cast<bf16*>(dk), sk * w, w, head_dim};
  p.dv = {static_cast<bf16*>(dv), sk * w, w, head_dim};
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.kv_ids = static_cast<const int*>(kv_ids);
  p.heads = num_heads;
  p.sq = sq;
  p.n_keys = sk;
  p.n_kv_rows = sk;
  p.scale = scale;
  const auto s = static_cast<cudaStream_t>(stream);
  return head_dim == 64 ? attn_bwd::launch_bwd<64>(p, batch, s)
                        : attn_bwd::launch_bwd<32>(p, batch, s);
}
