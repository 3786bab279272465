// Multi-head attention forward for Hopper (sm_90a) in the (B, S, H, D)
// layout, bf16 in, bf16 out.
//
// Replaces labelany3d_tpu/ops/attention.py::flash_sdpa, which wraps the
// Pallas TPU library kernel jax.experimental.pallas.ops.tpu.flash_attention.
// It computes the same function: non-causal attention of q (B, Sq, H, D)
// against k, v (B, Sk, H, D), Sq and Sk free to differ (cross attention),
// scale 1/sqrt(d), fp32 softmax and accumulation, and keys masked where an
// optional (B, Sk) int32 id array is non-zero (the segment-id pad mask).
// The output is (B, Sq, H, D), contiguous.
//
// Design. The TPU kernel holds the whole K/V block of a head in VMEM and
// pads both sequences to a multiple of 128. Neither carries over: a block
// has at most 227 KB of shared memory. So, as in packed_attention.cu:
//   * one block of 4 warps per (query tile of 64 rows, head, batch row);
//     each warp owns 16 query rows;
//   * key tiles of 64 rows stream through shared memory with an online
//     softmax (running max and sum in fp32, log2 domain);
//   * q, k and v are read in place through their strides (16-byte loads of
//     each row's head slice): no transpose or pad pass over device memory;
//   * QK^T and PV run on the tensor cores through mma.sync m16n8k16 bf16
//     with fp32 accumulators; P is rounded to bf16 before PV, as on the TPU;
//   * the ragged tails are masked here: query rows >= Sq are loaded as zeros
//     and never written; key rows >= Sk, or whose id is non-zero, are
//     loaded as zeros and their scores set to -inf, so a NaN in a pad row
//     never reaches an output. Fully masked rows are guarded against
//     (-inf) - (-inf) and write zeros.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the
// matcher decoder's call, P pairs x 1296 queries x 1296 keys x 12 heads of
// 64, does 4*P*H*Sq*Sk*d operations against 2*P*(2*Sq + 2*Sk)*H*d bytes:
// 165 GFLOP (0.167 ms) against 255 MB (0.076 ms) at P = 32: operations.
// This first version uses mma.sync (not wgmma/TMA) and no pipelining of the
// K/V loads, so it reaches a fraction of that; making it fast is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // query rows per block = key rows per tile
constexpr int kWarps = 4;        // 16 query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;          // smem row padding (bf16) against bank conflicts

struct Strides {                 // element strides; the head dim is contiguous
  long long b, s, h;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy the 64 x D tile of rows row0.. of one (batch row, head) slice into
// shared memory. Rows >= row_limit, and rows whose id is non-zero, are
// written as zeros; `ok` (when given) records which rows are real.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          int row0, int row_limit, long long row_stride,
                                          const int* ids, bool* ok) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const int row = row0 + r;
    const bool real = row < row_limit && (ids == nullptr || ids[row] == 0);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (real) {
      v = *reinterpret_cast<const uint4*>(base + (long long)row * row_stride + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c * 8) = v;
    if (ok != nullptr && c == 0) ok[r] = real;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out,
                       const int* __restrict__ kv_ids, int sq, int sk,
                       int num_heads, Strides qs, Strides ks, Strides vs,
                       float scale_log2) {
  constexpr int LD = D + kPad;
  constexpr int KS = D / 16;     // k-steps over the head dim for QK^T
  constexpr int NT = D / 8;      // n-tiles over the head dim for PV
  constexpr int ST = kTile / 8;  // n-tiles over the keys of a tile

  __shared__ __align__(16) __nv_bfloat16 sq_[kTile * LD];
  __shared__ __align__(16) __nv_bfloat16 sk_[kTile * LD];
  __shared__ __align__(16) __nv_bfloat16 sv_[kTile * LD];
  __shared__ bool key_ok[kTile];

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb_ = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  const int* ids = kv_ids == nullptr ? nullptr : kv_ids + (long long)b * sk;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // row group within the 16-row fragment
  const int t = lane & 3;    // thread within the group

  load_tile<D>(sq_, qb, q0, sq, qs.s, nullptr, nullptr);
  __syncthreads();

  // Q fragments of this warp's 16 rows, kept in registers for every tile.
  uint32_t qa[KS][4];
  {
    const __nv_bfloat16* qw = sq_ + (warp * 16) * LD;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c = kk * 16 + t * 2;
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(qw + g * LD + c);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(qw + (g + 8) * LD + c);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(qw + g * LD + c + 8);
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(qw + (g + 8) * LD + c + 8);
    }
  }

  float o[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  // Running max (log2 domain) and sum for rows g and g + 8.
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  const int n_tiles = (sk + kTile - 1) / kTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // previous tile fully consumed
    load_tile<D>(sk_, kb_, k0, sk, ks.s, ids, key_ok);
    load_tile<D>(sv_, vb, k0, sk, vs.s, ids, nullptr);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[ST][4];
#pragma unroll
    for (int nt = 0; nt < ST; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = sk_ + (nt * 8 + g) * LD;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t kf[2];
        kf[0] = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + t * 2);
        kf[1] = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + t * 2 + 8);
        mma_bf16_16816(s[nt], qa[kk], kf);
      }
    }

    // Scale into the log2 domain, mask pad keys, row max.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < ST; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = nt * 8 + t * 2 + (e & 1);
        float val = s[nt][e] * scale_log2;
        val = key_ok[key] ? val : -INFINITY;
        s[nt][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }

    float alpha[2], m_ref[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], mx[r]);
      // Guard the all-masked case: keep exp() arguments finite.
      m_ref[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = m_run[r] == -INFINITY ? 0.f : exp2f(m_run[r] - m_ref[r]);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < ST; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m_ref[e >> 1]);  // exp2(-inf) = 0
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_run[r] = l_run[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    // O += P V. The accumulator layout of two adjacent 8-key n-tiles is the
    // A-fragment layout of one 16-key k-step.
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* v0 = sv_ + (kk * 16 + t * 2) * LD;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = nt * 8 + g;
        __nv_bfloat162 lo, hi;
        lo.x = v0[c];
        lo.y = v0[LD + c];
        hi.x = v0[8 * LD + c];
        hi.y = v0[9 * LD + c];
        uint32_t vf[2] = {*reinterpret_cast<uint32_t*>(&lo),
                          *reinterpret_cast<uint32_t*>(&hi)};
        mma_bf16_16816(o[nt], pa, vf);
      }
    }
  }

  // Normalise and store bf16 pairs of the real query rows.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;
  const long long w = (long long)num_heads * D;
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
  __nv_bfloat16* oa = out + ((long long)b * sq + row_a) * w + h * D;
  __nv_bfloat16* ob = oa + 8 * w;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = nt * 8 + t * 2;
    if (row_a < sq)
      *reinterpret_cast<uint32_t*>(oa + c) = pack_bf16(o[nt][0] * inv[0], o[nt][1] * inv[0]);
    if (row_b < sq)
      *reinterpret_cast<uint32_t*>(ob + c) = pack_bf16(o[nt][2] * inv[1], o[nt][3] * inv[1]);
  }
}

}  // namespace

// C entry point (bound with ctypes). Strides are in elements; the head dim
// of q, k and v is contiguous. `kv_ids` is null or a (B, Sk) int32 array
// (0 = real key). Launches on `stream` and returns cudaGetLastError() so a
// refused launch is reported to the caller.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   const void* kv_ids, int batch, int sq, int sk,
                                   int num_heads, int head_dim,
                                   long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss, long long v_sh,
                                   float scale, void* stream) {
  if (head_dim != 64 || sq < 1 || sk < 1 || batch < 1 || num_heads < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((sq + kTile - 1) / kTile, num_heads, batch);
  const float log2e = 1.4426950408889634f;
  flash_attention_kernel<64><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<const int*>(kv_ids), sq, sk, num_heads, Strides{q_sb, q_ss, q_sh},
      Strides{k_sb, k_ss, k_sh}, Strides{v_sb, v_ss, v_sh}, scale * log2e);
  return (int)cudaGetLastError();
}
