// Packed self-attention forward for Hopper (sm_90a), bf16 in, bf16 out.
//
// Replaces labelany3d_tpu/ops/attention.py::_packed_flash_fwd (the Pallas
// TPU kernel behind packed_flash_sdpa). It computes the same function:
// non-causal multi-head attention read straight from the packed
// (B, Npad, 3W) qkv tensor of the fused QKV projection -- q, k and v are the
// column ranges [0, W), [W, 2W) and [2W, 3W) -- with keys at index >= n_real
// masked, scale 1/sqrt(d), fp32 softmax and fp32 accumulation. Output is
// (B, Npad, W) with head h in columns [h*d, (h+1)*d).
//
// Design. The TPU kernel keeps a whole key row (1408 keys) in VMEM and runs
// an exact two-pass softmax. A 64 x 1408 fp32 score tile plus K and V does
// not fit in one block's 227 KB of shared memory, so this kernel streams key
// tiles of 64 rows with an online softmax (running max and sum in fp32):
//   * one block of 4 warps per (query tile of 64 rows, head, batch);
//     each warp owns 16 query rows;
//   * Q, K and V tiles are read with 16-byte vector loads at row stride 3W
//     (no split or transpose pass over device memory);
//   * QK^T and PV run on the tensor cores through mma.sync m16n8k16 bf16
//     with fp32 accumulators; P is rounded to bf16 before PV, as on the TPU;
//   * key tiles wholly at or beyond n_real are skipped. In the last partial
//     tile, K/V rows >= n_real are loaded as zeros and their scores set to
//     -inf, so a NaN in a pad row can never reach a real output (the TPU
//     kernel multiplies p = 0 by whatever the pad V rows hold). Fully
//     masked rows are guarded against (-inf) - (-inf).
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s). Every
// query row, pad rows included, is computed and written, against the n_real
// real keys: operations 4*B*H*Npad*n_real*d; bytes are Q read and the output
// written over Npad rows, K and V read over n_real rows (bf16).
//   MoGe call (B=8, Npad=1408, n_real=1297, H=16, d=64): 59.8 GFLOP
//     -> 0.060 ms against 88.6 MB -> 0.026 ms: operations.
//   DepthPro call (B=40, Npad=384, n_real=325): 20.4 GFLOP -> 0.021 ms
//     against 116.1 MB -> 0.035 ms: bytes.
// This first version uses mma.sync (not wgmma/TMA) and no pipelining of the
// K/V loads, so it reaches a fraction of those bounds; making it fast is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // query rows per block = key rows per tile
constexpr int kWarps = 4;        // 16 query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;          // smem row padding (bf16) against bank conflicts

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

// Copy a 64 x D tile (rows row0.., columns col0..) of the packed tensor into
// shared memory; rows >= row_limit are written as zeros.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* base,
                                          int row0, int row_limit,
                                          long long row_stride, int col0) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < row_limit) {
      v = *reinterpret_cast<const uint4*>(
          base + (long long)(row0 + r) * row_stride + col0 + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c * 8) = v;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
packed_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                        __nv_bfloat16* __restrict__ out, int n_pad,
                        int num_heads, int n_real, float scale_log2) {
  constexpr int LD = D + kPad;
  constexpr int KS = D / 16;   // k-steps over the head dim for QK^T
  constexpr int NT = D / 8;    // n-tiles over the head dim for PV
  constexpr int ST = kTile / 8;  // n-tiles over the keys of a tile

  __shared__ __align__(16) __nv_bfloat16 sq[kTile * LD];
  __shared__ __align__(16) __nv_bfloat16 sk[kTile * LD];
  __shared__ __align__(16) __nv_bfloat16 sv[kTile * LD];

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int w = num_heads * D;
  const long long stride = 3LL * w;
  const __nv_bfloat16* base = qkv + (long long)b * n_pad * stride;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // row group within the 16-row fragment
  const int t = lane & 3;    // thread within the group

  load_tile<D>(sq, base, q0, n_pad, stride, h * D);
  __syncthreads();

  // Q fragments of this warp's 16 rows, kept in registers for every tile.
  uint32_t qa[KS][4];
  {
    const __nv_bfloat16* qw = sq + (warp * 16) * LD;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c = ks * 16 + t * 2;
      qa[ks][0] = *reinterpret_cast<const uint32_t*>(qw + g * LD + c);
      qa[ks][1] = *reinterpret_cast<const uint32_t*>(qw + (g + 8) * LD + c);
      qa[ks][2] = *reinterpret_cast<const uint32_t*>(qw + g * LD + c + 8);
      qa[ks][3] = *reinterpret_cast<const uint32_t*>(qw + (g + 8) * LD + c + 8);
    }
  }

  float o[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  // Running max (log2 domain) and sum for rows g and g + 8.
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  const int n_tiles = (n_real + kTile - 1) / kTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // previous tile fully consumed
    load_tile<D>(sk, base, k0, n_real, stride, w + h * D);
    load_tile<D>(sv, base, k0, n_real, stride, 2 * w + h * D);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[ST][4];
#pragma unroll
    for (int nt = 0; nt < ST; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = sk + (nt * 8 + g) * LD;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kb[2];
        kb[0] = *reinterpret_cast<const uint32_t*>(kr + ks * 16 + t * 2);
        kb[1] = *reinterpret_cast<const uint32_t*>(kr + ks * 16 + t * 2 + 8);
        mma_bf16_16816(s[nt], qa[ks], kb);
      }
    }

    // Scale into the log2 domain, mask pad keys, row max.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < ST; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + t * 2 + (e & 1);
        float v = s[nt][e] * scale_log2;
        v = key < n_real ? v : -INFINITY;
        s[nt][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
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
      const __nv_bfloat16* v0 = sv + (kk * 16 + t * 2) * LD;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = nt * 8 + g;
        __nv_bfloat162 lo, hi;
        lo.x = v0[c];
        lo.y = v0[LD + c];
        hi.x = v0[8 * LD + c];
        hi.y = v0[9 * LD + c];
        uint32_t vb[2] = {*reinterpret_cast<uint32_t*>(&lo),
                          *reinterpret_cast<uint32_t*>(&hi)};
        mma_bf16_16816(o[nt], pa, vb);
      }
    }
  }

  // Normalise and store bf16 pairs.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;
  const int row_a = q0 + warp * 16 + g;
  __nv_bfloat16* oa = out + ((long long)b * n_pad + row_a) * w + h * D;
  __nv_bfloat16* ob = oa + 8LL * w;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = nt * 8 + t * 2;
    *reinterpret_cast<uint32_t*>(oa + c) = pack_bf16(o[nt][0] * inv[0], o[nt][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(ob + c) = pack_bf16(o[nt][2] * inv[1], o[nt][3] * inv[1]);
  }
}

}  // namespace

// C entry point (bound with ctypes). Launches on `stream` and returns
// cudaGetLastError() so a refused launch is reported to the caller.
extern "C" int packed_attention_fwd(const void* qkv, void* out, int batch,
                                    int n_pad, int num_heads, int head_dim,
                                    int n_real, float scale, void* stream) {
  if (head_dim != 64 || n_pad % kTile != 0 || n_real < 1 || n_real > n_pad) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(n_pad / kTile, num_heads, batch);
  const float log2e = 1.4426950408889634f;
  packed_attention_kernel<64><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
      n_pad, num_heads, n_real, scale * log2e);
  return (int)cudaGetLastError();
}
