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
// the same strided operands and segment ids (StridedBwdLoader: TMA maps of
// q, k, v, the output and its cotangent through their strides), from the
// row log-sum-exp that the forward writes when asked (`lse`).
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

// The backward's loader (attention_bwd_sm90.cuh): the same (D, H, S, B)
// maps of the strided operands, with the boxes the two kernels load (64
// query rows, 128 keys), and maps of the contiguous gradients.
template <int D>
struct StridedBwdLoader {
  static constexpr int kHeadDim = D;
  CUtensorMap q, dout, out;  // box 64 rows
  CUtensorMap k, v;          // box 128 rows
  CUtensorMap dq, dk, dv;    // (D, H, S, B), contiguous; box 64 rows
  const int* ids;            // (B, Sk), 0 = real key; or null
  const float* lse;          // (B, H, Sq), the forward's
  float* l2s;                // (B, H, rows_pad) scratch: LSE in log2 units
  float* dls;                // (B, H, rows_pad) scratch: D
  int n_keys;                // Sk
  int n_rows;                // Sq
  int n_kv_rows;             // Sk
  int rows_pad;              // Sq rounded up to 64
  float scale;

  __device__ const int* key_ids(int b) const {
    return ids == nullptr ? nullptr : ids + static_cast<long long>(b) * n_keys;
  }
  __device__ void prefetch() const {
    prefetch_map(&q);
    prefetch_map(&dout);
    prefetch_map(&out);
    prefetch_map(&k);
    prefetch_map(&v);
  }
  __device__ void load_q(uint32_t dst, uint32_t bar, int r0, int h, int b) const {
    tma_load_4d(dst, &q, bar, 0, h, r0, b);
  }
  __device__ void load_do(uint32_t dst, uint32_t bar, int r0, int h, int b) const {
    tma_load_4d(dst, &dout, bar, 0, h, r0, b);
  }
  __device__ void load_o(uint32_t dst, uint32_t bar, int r0, int h, int b) const {
    tma_load_4d(dst, &out, bar, 0, h, r0, b);
  }
  __device__ void load_k(uint32_t dst, uint32_t bar, int r0, int h, int b) const {
    tma_load_4d(dst, &k, bar, 0, h, r0, b);
  }
  __device__ void load_v(uint32_t dst, uint32_t bar, int r0, int h, int b) const {
    tma_load_4d(dst, &v, bar, 0, h, r0, b);
  }
  __device__ void store_dq(uint32_t src, int r0, int h, int b) const {
    tma_store_4d(&dq, src, 0, h, r0, b);
  }
  __device__ void store_dk(uint32_t src, int r0, int h, int b) const {
    tma_store_4d(&dk, src, 0, h, r0, b);
  }
  __device__ void store_dv(uint32_t src, int r0, int h, int b) const {
    tma_store_4d(&dv, src, 0, h, r0, b);
  }
};

// in: q, k, v, out, dout; grads: dq, dk, dv; st: their (sb, ss, sh)
// element strides in that order.
template <int D>
int run_bwd(const void* const (&in)[5], void* const (&grads)[3], const void* lse,
            void* lse_rows, void* delta_rows, const void* kv_ids, int batch, int sq, int sk,
            int num_heads, const long long (&st)[15], float scale, cudaStream_t stream) {
  StridedBwdLoader<D> ld;
  const long long w = static_cast<long long>(num_heads) * D;
  const int seq[5] = {sq, sk, sk, sq, sq};
  const int box[5] = {attn_bwd::kQTile, attn_bwd::kKTile, attn_bwd::kKTile, attn_bwd::kQTile,
                      attn_bwd::kQTile};
  CUtensorMap* maps[5] = {&ld.q, &ld.k, &ld.v, &ld.out, &ld.dout};
  int err = 0;
  for (int i = 0; i < 5 && err == 0; ++i) {
    err = encode_operand<D>(maps[i], in[i], batch, seq[i], num_heads, st[3 * i],
                            st[3 * i + 1], st[3 * i + 2], box[i]);
  }
  if (err == 0) err = encode_operand<D>(&ld.dq, grads[0], batch, sq, num_heads, sq * w, w, D, 64);
  if (err == 0) err = encode_operand<D>(&ld.dk, grads[1], batch, sk, num_heads, sk * w, w, D, 64);
  if (err == 0) err = encode_operand<D>(&ld.dv, grads[2], batch, sk, num_heads, sk * w, w, D, 64);
  if (err != 0) return err;
  ld.ids = static_cast<const int*>(kv_ids);
  ld.lse = static_cast<const float*>(lse);
  ld.l2s = static_cast<float*>(lse_rows);
  ld.dls = static_cast<float*>(delta_rows);
  ld.n_keys = sk;
  ld.n_rows = sq;
  ld.n_kv_rows = sk;
  ld.rows_pad = (sq + 63) / 64 * 64;
  ld.scale = scale;
  return attn_bwd::launch_bwd(ld, num_heads, batch, stream);
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
// (B, S, H, D) bf16 arrays, from q, k, v, the forward's output `out` and the
// output's cotangent `dout`, all read through their element strides, the
// forward's `lse` (B, H, Sq) fp32 and `kv_ids`. `lse_rows` and `delta_rows`
// are (B, H, Sq rounded up to 64) fp32 scratch arrays that the dQ kernel
// fills (each row's LSE in log2 units, +inf for a dead row, and
// D = rowsum(dout * out)) and the dK/dV kernel reads. Returns as the forward
// does.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const void* lse, void* lse_rows,
                                   void* delta_rows, const void* kv_ids, void* dq, void* dk,
                                   void* dv, int batch, int sq, int sk, int num_heads,
                                   int head_dim, long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss, long long v_sh,
                                   long long o_sb, long long o_ss, long long o_sh,
                                   long long do_sb, long long do_ss, long long do_sh,
                                   float scale, void* stream) {
  if ((head_dim != 64 && head_dim != 32) || sq < 1 || sk < 1 || batch < 1 || num_heads < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (const int err = attn_bwd::bind_context()) return err;
  const long long st[15] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                            o_sb, o_ss, o_sh, do_sb, do_ss, do_sh};
  const void* in[5] = {q, k, v, out, dout};
  void* grads[3] = {dq, dk, dv};
  const auto s = static_cast<cudaStream_t>(stream);
  return head_dim == 64
             ? run_bwd<64>(in, grads, lse, lse_rows, delta_rows, kv_ids, batch, sq, sk,
                           num_heads, st, scale, s)
             : run_bwd<32>(in, grads, lse, lse_rows, delta_rows, kv_ids, batch, sq, sk,
                           num_heads, st, scale, s);
}
