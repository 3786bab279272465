// Nearest bank row by dot similarity, per query row, for Hopper (sm_90a).
//
// Replaces labelany3d_tpu/ops/reciprocal_nn.py::nn_argmax_tiled (the Pallas
// TPU kernel behind the matcher's reciprocal nearest-neighbour rounds). It
// computes the same function: for every query row, the index and the value
// of the highest dot product against the bank rows [0, n_real); ties go to
// the first maximum (jnp.argmax). Precision 'bf16' scores bf16-rounded
// operands with fp32 accumulation; 'bf16x3' splits each fp32 operand into a
// bf16 high and low part and sums hi*hi + hi*lo + lo*hi (near fp32).
// Operands are batched over pairs: query (P, S, 32) and bank (P, Nb, 32)
// fp32, the descriptor width zero-padded to 32 (ops/reciprocal_nn.py::
// pad_bank_for_nn); rows of the bank at or beyond n_real are never read, so
// they may hold anything.
//
// Design. The TPU kernel pads the descriptor width C = 24 to 128 lanes and
// carries a running (max, argmax) across sequential grid steps in VMEM.
// Here the width is padded only to the MMA depth (two k-steps of
// m16n8k16), and each block owns 64 query rows of one pair and walks the
// whole bank itself, so nothing is carried between blocks:
//   * the block's query fragments (hi, and lo for bf16x3) stay in
//     registers; bank tiles of 64 rows are read from device memory (L2 for
//     the 25 MB matcher bank), split to bf16 in shared memory, and scored
//     with mma.sync into fp32 accumulators;
//   * the score tile never leaves registers: each thread keeps a running
//     (best, first index) for its two query rows over the columns it owns,
//     visited in increasing index order, and the four threads of a row
//     reduce at the end (larger value wins, equal values the lower index).
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the
// registration call, 4096 queries x 262144 bank rows x C = 24, is
// 2*S*N*C = 51.5 GFLOP (0.052 ms) against 25.6 MB of operands (0.008 ms):
// operations. This first version has no pipelining of the bank loads and
// converts every bank tile in every block, so it reaches a fraction of that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;        // query rows per block = bank rows per tile
constexpr int kWarps = 4;        // 16 query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kC = 32;           // padded descriptor width (two MMA k-steps)
constexpr int kLD = kC + 8;      // smem row stride (bf16) against bank conflicts
constexpr int kSteps = kC / 16;

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Split two fp32 values into packed bf16 (hi) and packed bf16 residuals (lo).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t* hi, uint32_t* lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __bfloat162float(h.x),
                                           x1 - __bfloat162float(h.y));
  *hi = *reinterpret_cast<uint32_t*>(&h);
  *lo = *reinterpret_cast<uint32_t*>(&l);
}

template <bool kX3>
__global__ void __launch_bounds__(kThreads)
nn_argmax_kernel(const float* __restrict__ query, const float* __restrict__ bank,
                 int* __restrict__ idx_out, float* __restrict__ best_out,
                 int s, int n_bank, int n_real) {
  __shared__ __align__(16) __nv_bfloat16 bh[kRows * kLD];
  __shared__ __align__(16) __nv_bfloat16 bl[kX3 ? kRows * kLD : 8];

  const int q0 = blockIdx.x * kRows;
  const int p = blockIdx.y;
  const float* qp = query + (long long)p * s * kC;
  const float* bp = bank + (long long)p * n_bank * kC;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // row group within the 16-row fragment
  const int t = lane & 3;    // thread within the group
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;

  // A fragments of this warp's 16 query rows, straight from device memory.
  uint32_t qh[kSteps][4], ql[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int row = (f & 1) ? row_b : row_a;
      const int c = kk * 16 + t * 2 + ((f & 2) ? 8 : 0);
      float x0 = 0.f, x1 = 0.f;
      if (row < s) {
        const float2 xv = *reinterpret_cast<const float2*>(qp + (long long)row * kC + c);
        x0 = xv.x;
        x1 = xv.y;
      }
      split2(x0, x1, &qh[kk][f], &ql[kk][f]);
    }
  }

  float best[2] = {-INFINITY, -INFINITY};
  int bidx[2] = {0, 0};

  const int n_tiles = (n_real + kRows - 1) / kRows;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kRows;
    __syncthreads();  // previous tile fully consumed
    for (int i = threadIdx.x; i < kRows * kC / 4; i += kThreads) {
      const int r = i / (kC / 4);
      const int c = (i % (kC / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < n_real) {
        x = *reinterpret_cast<const float4*>(bp + (long long)(k0 + r) * kC + c);
      }
      uint2 hv, lv;
      split2(x.x, x.y, &hv.x, &lv.x);
      split2(x.z, x.w, &hv.y, &lv.y);
      *reinterpret_cast<uint2*>(bh + r * kLD + c) = hv;
      if (kX3) *reinterpret_cast<uint2*>(bl + r * kLD + c) = lv;
    }
    __syncthreads();

#pragma unroll
    for (int nt = 0; nt < kRows / 8; ++nt) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const int r = nt * 8 + g;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const int c = kk * 16 + t * 2;
        uint32_t fb[2] = {*reinterpret_cast<const uint32_t*>(bh + r * kLD + c),
                          *reinterpret_cast<const uint32_t*>(bh + r * kLD + c + 8)};
        mma_bf16_16816(acc, qh[kk], fb);
        if (kX3) {
          uint32_t fl[2] = {*reinterpret_cast<const uint32_t*>(bl + r * kLD + c),
                            *reinterpret_cast<const uint32_t*>(bl + r * kLD + c + 8)};
          mma_bf16_16816(acc, qh[kk], fl);
          mma_bf16_16816(acc, ql[kk], fb);
        }
      }
      // Columns nt*8 + t*2 + {0, 1}, in increasing order: strict > keeps
      // the first maximum this thread sees.
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + t * 2 + (e & 1);
        if (col < n_real && acc[e] > best[e >> 1]) {
          best[e >> 1] = acc[e];
          bidx[e >> 1] = col;
        }
      }
    }
  }

  // Reduce over the four threads that share a row: larger value, then the
  // lower index.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best[r], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[r], off);
      if (ov > best[r] || (ov == best[r] && oi < bidx[r])) {
        best[r] = ov;
        bidx[r] = oi;
      }
    }
  }
  if (t == 0) {
    if (row_a < s) {
      idx_out[(long long)p * s + row_a] = bidx[0];
      best_out[(long long)p * s + row_a] = best[0];
    }
    if (row_b < s) {
      idx_out[(long long)p * s + row_b] = bidx[1];
      best_out[(long long)p * s + row_b] = best[1];
    }
  }
}

}  // namespace

// C entry point (bound with ctypes). query (P, S, 32) and bank (P, Nb, 32)
// fp32, contiguous; outputs (P, S) int32 and fp32. precision 0 = bf16,
// 1 = bf16x3. Launches on `stream` and returns cudaGetLastError().
extern "C" int nn_argmax_fwd(const void* query, const void* bank, void* idx, void* best,
                             int pairs, int s, int n_bank, int n_real, int width,
                             int precision, void* stream) {
  if (width != kC || pairs < 1 || s < 1 || n_real < 1 || n_real > n_bank ||
      (precision != 0 && precision != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((s + kRows - 1) / kRows, pairs);
  auto q = static_cast<const float*>(query);
  auto b = static_cast<const float*>(bank);
  auto i = static_cast<int*>(idx);
  auto v = static_cast<float*>(best);
  if (precision == 0) {
    nn_argmax_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(q, b, i, v, s,
                                                                          n_bank, n_real);
  } else {
    nn_argmax_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(q, b, i, v, s,
                                                                         n_bank, n_real);
  }
  return (int)cudaGetLastError();
}
