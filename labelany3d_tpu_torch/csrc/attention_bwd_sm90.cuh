// The Hopper (sm_90a) backward of the port's two attention kernels, shared
// by flash_attention.cu (K2, q, k, v in (B, S, H, D) read through strides)
// and packed_attention.cu (K1, the packed (B, Npad, 3W) qkv tensor, whose
// q, k and v are column ranges read through the same strides). Each of
// those files is a thin entry point that fills `BwdParams`; the two kernels
// and their loads are here, once.
//
// Replaces the backward of the Pallas TPU library's flash_attention, which
// labelany3d_tpu/ops/attention.py::flash_sdpa calls (library :125): its
// custom VJP runs _flash_attention_bwd_dkv (`pallas_call` :1121 of
// jax/experimental/pallas/ops/tpu/flash_attention.py) and
// _flash_attention_bwd_dq (`pallas_call` :1456), after computing
// di = rowsum(o * do) in XLA (:273). The split is the library's:
//
//   dkdv_kernel  a block owns 64 keys of one (batch, head) and loops over
//                every query tile: S^T = K Q^T, P^T = exp(S^T * scale -
//                LSE), dP^T = V dO^T, dS^T = P^T o (dP^T - D), then
//                dV += P^T dO and dK += dS^T Q (times scale at the end).
//   dq_kernel    a block owns 64 queries and loops over every key tile:
//                the same S, P, dP and dS, then dQ += dS K (times scale).
//
// Nothing is carried between blocks and no block adds into another's
// output, so neither kernel uses atomics: a step repeats bit for bit.
// D = rowsum(dO o O) in fp32 and the row log-sum-exp LSE (natural log, the
// library's m + log(l), written by the forward: attention_sm90.cuh) come
// from the caller. P and dS are rounded to bf16 before their products, and
// every product accumulates in fp32: the arithmetic of the library's
// kernels and of the JAX package's XLA VJP on bf16 operands.
//
// Masking. A key at or past `n_keys`, or whose id is non-zero, is masked:
// its K and V rows are loaded as zeros (whatever they hold, NaN included)
// and its P is set to 0 by adding -inf to the exponent, so its dS is 0 and
// its dK and dV rows are written as zeros. A query row with LSE = +inf
// takes no part: its Q row is loaded as zeros, so its P is exp2(-inf) = 0
// and it adds nothing to dK or dV, and its dQ row is 0. The forward writes
// +inf for a row whose keys are all masked (its output is 0), and the
// caller sets +inf (and D = 0) for a row whose cotangent is zero, which in
// exact arithmetic adds nothing: so NaN in a pad row that feeds nothing
// reaches no gradient. Query rows past `sq` are loaded as zeros with
// LSE = +inf.
//
// Design: a simple tensor-core kernel, right before fast. Four warps a
// block, each owning 16 of the block's 64 rows; mma.sync m16n8k16 bf16
// with fp32 accumulators; operands fetched by ldmatrix from shared-memory
// tiles whose rows are padded by 16 bytes (no bank conflicts); the
// streamed tiles loaded by cp.async with zero-fill (which is also how
// masked rows and ragged tails become zeros) into two buffers, so the
// next tile's loads overlap this tile's products. The block's own rows
// (K and V in dkdv_kernel, Q and dO in dq_kernel) are held as A fragments
// in registers for the whole loop. P and dS never leave registers: the
// accumulator layout of S^T (or S) packed to bf16 is the A-fragment layout
// of the next product.
//
// What bounds it on an H100 SXM: five products of 2 * Sq * Sk * d
// operations a head (QK^T twice, dO V^T twice, and dV, dK, dQ: the library
// recomputes S and dP in both kernels, as this does), against reading q,
// k, v, o, do and writing dq, dk, dv once. At every path shape the tensor
// cores bound it (ten 2 * Sq * Sk * d against 989 TFLOP/s bf16). mma.sync
// reaches well under wgmma's rate on Hopper; moving these loops onto the
// forward's TMA + wgmma machinery is later work.

#pragma once

#include "sm90_common.cuh"

namespace attn_bwd {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;             // rows a block owns
constexpr int kTile = 64;             // rows of a streamed tile
constexpr int kWarps = 4;             // 16 of the block's rows each
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

// A (B, S, H, D) bf16 tensor through its element strides; the head dim is
// contiguous. Outputs use the same description.
struct Operand {
  const bf16* ptr;
  long long sb, ss, sh;
};
struct OutOperand {
  bf16* ptr;
  long long sb, ss, sh;
};

struct BwdParams {
  Operand q, k, v, dout;     // dout: the cotangent of the output, (B, Sq, H, D)
  OutOperand dq, dk, dv;
  const float* lse;          // (B, H, Sq): natural-log LSE; +inf = the row takes no part
  const float* delta;        // (B, H, Sq): rowsum(dO o O) in fp32
  const int* kv_ids;         // (B, n_keys) int32, non-zero = masked; or null
  int heads;
  int sq;                    // query rows
  int n_keys;                // keys at or past this are masked
  int n_kv_rows;             // rows of dK and dV to write (>= n_keys; the rest are zeros)
  float scale;
};

// The padded shared-memory tile of kTile rows of D bf16.
template <int D>
struct Smem {
  static_assert(D == 64 || D == 32, "the attention backward takes head dim 64 or 32");
  static constexpr int kStride = D + 8;                 // elements a row: +16 bytes
  static constexpr int kTileBytes = kTile * kStride * 2;
  static constexpr int kChunks = D / 8;                 // 16-byte chunks a row
  // Two block-owned tiles, two double-buffered streamed tiles, and two
  // double-buffered vectors of kTile floats (dkdv: LSE and D; dq: the key
  // bias in one of them).
  static constexpr int kBytes = 6 * kTileBytes + 4 * kTile * 4;
};

// ---------------------------------------------------------------- PTX ---

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// D (16 x 8, fp32) += A (16 x 16, bf16, row) * B (16 x 8, bf16, col).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------- pieces ---
//
// Fragment layouts (m16n8k16): in an accumulator c[j][e] of a warp's 16
// rows, lane (g = lane / 4, t = lane % 4) holds row g + 8 (e >> 1), column
// 8 j + 2 t + (e & 1). Packed to bf16 two at a time, the accumulators of
// columns 16 kk .. 16 kk + 15 are the A fragment of k-step kk.

// cp.async kTile rows of `op` from row r0 of (b, h) into the padded tile at
// `dst`; a row at or past `limit`, or for which ok(row) is false, is
// zero-filled.
template <int D, class Ok>
__device__ __forceinline__ void load_rows(uint32_t dst, const Operand& op, int b, int h, int r0,
                                          int limit, Ok ok) {
  using S = Smem<D>;
  const bf16* base = op.ptr + b * op.sb + h * op.sh;
#pragma unroll
  for (int j = 0; j < kTile * S::kChunks / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / S::kChunks;
    const int ch = i % S::kChunks;
    const int row = r0 + r;
    const bool valid = row < limit && ok(row);
    const bf16* src = valid ? base + row * op.ss + ch * 8 : op.ptr;
    cp_async16(dst + (r * S::kStride + ch * 8) * 2, src, valid);
  }
}

// The A fragments (16 rows x D) of rows w16 .. w16 + 15 of a tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], uint32_t tile, int w16,
                                       int lane) {
  using S = Smem<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldsm_x4(a[kk], tile + ((w16 + (lane & 15)) * S::kStride + kk * 16 + (lane >> 4) * 8) * 2);
  }
}

// acc (16 x 64) = A (16 x D, registers) * T^T, T a tile of 64 rows x D (the
// B operand "col": rows of T are the columns of the product).
template <int D>
__device__ __forceinline__ void product_nt(float (&acc)[8][4], const uint32_t (&a)[D / 16][4],
                                           uint32_t tile, int lane) {
  using S = Smem<D>;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, tile + ((np * 16 + (lane & 7) + (lane >> 4) * 8) * S::kStride + kk * 16 +
                          ((lane >> 3) & 1) * 8) * 2);
      mma16816(acc[2 * np], a[kk], bf[0], bf[1]);
      mma16816(acc[2 * np + 1], a[kk], bf[2], bf[3]);
    }
  }
}

// acc (16 x D) += X (16 x 64, fp32 accumulators, rounded to bf16 here) * T,
// T a tile of 64 rows x D (the B operand read transposed).
template <int D>
__device__ __forceinline__ void product_nn(float (&acc)[D / 8][4], const float (&x)[8][4],
                                           uint32_t tile, int lane) {
  using S = Smem<D>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {sm90::pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           sm90::pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           sm90::pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           sm90::pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t bf[4];
      ldsm_x4_t(bf, tile + ((kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S::kStride +
                            np * 16 + (lane >> 4) * 8) * 2);
      mma16816(acc[2 * np], a, bf[0], bf[1]);
      mma16816(acc[2 * np + 1], a, bf[2], bf[3]);
    }
  }
}

// Rows w16 + g and w16 + g + 8 of a (16 x D) accumulator, times `scale`, in
// bf16 into rows row0 + ... of (b, h) of `out`, below `limit`.
template <int D>
__device__ __forceinline__ void store_rows(const OutOperand& out, int b, int h, int row0,
                                           int limit, const float (&acc)[D / 8][4], float scale,
                                           int lane) {
  bf16* base = out.ptr + b * out.sb + h * out.sh;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= limit) continue;
    bf16* dst = base + row * out.ss + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          sm90::pack_bf16(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
    }
  }
}

// Zeros into rows r0 .. min(r0 + kRows, limit) - 1 of (b, h) of `out`.
template <int D>
__device__ __forceinline__ void store_zeros(const OutOperand& out, int b, int h, int r0,
                                            int limit) {
  bf16* base = out.ptr + b * out.sb + h * out.sh;
  for (int j = 0; j < kRows * (D / 2) / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int row = r0 + i / (D / 2);
    if (row < limit) *reinterpret_cast<uint32_t*>(base + row * out.ss + 2 * (i % (D / 2))) = 0u;
  }
}

// ------------------------------------------------------------ kernels ---

// dK and dV of 64 keys of one (batch, head); grid (ceil(n_kv_rows / 64),
// heads, batch).
template <int D>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const __grid_constant__ BwdParams p) {
  using S = Smem<D>;
  extern __shared__ __align__(16) uint8_t bwd_smem[];
  const uint32_t base = sm90::smem_addr(bwd_smem);
  const uint32_t s_k = base;
  const uint32_t s_v = s_k + S::kTileBytes;
  const uint32_t s_q = s_v + S::kTileBytes;             // [2]
  const uint32_t s_do = s_q + 2 * S::kTileBytes;        // [2]
  float* s_lse = reinterpret_cast<float*>(bwd_smem + 6 * S::kTileBytes);  // [2][kTile], log2 units
  float* s_delta = s_lse + 2 * kTile;                                     // [2][kTile]

  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (k0 >= p.n_keys) {
    // Every key of this block is masked: its gradients are zero.
    store_zeros<D>(p.dk, b, h, k0, p.n_kv_rows);
    store_zeros<D>(p.dv, b, h, k0, p.n_kv_rows);
    return;
  }
  const int lane = threadIdx.x & 31;
  const int w16 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int* ids = p.kv_ids == nullptr ? nullptr : p.kv_ids + static_cast<long long>(b) * p.n_keys;
  const long long row_base = (static_cast<long long>(b) * p.heads + h) * p.sq;
  const float* lse = p.lse + row_base;
  const float* delta = p.delta + row_base;
  const float sl2 = p.scale * kLog2e;

  auto key_ok = [&](int key) { return ids == nullptr || ids[key] == 0; };
  auto live = [&](int row) { return lse[row] != INFINITY; };
  auto any = [](int) { return true; };
  // The query tile qt: Q (dead rows as zeros), dO, and LSE (log2 units;
  // +inf past the end) and D into buffer `buf`.
  auto issue_q = [&](int qt, int buf) {
    const int r0 = qt * kTile;
    load_rows<D>(s_q + buf * S::kTileBytes, p.q, b, h, r0, p.sq, live);
    load_rows<D>(s_do + buf * S::kTileBytes, p.dout, b, h, r0, p.sq, any);
    cp_async_commit();
    if (threadIdx.x < kTile) {
      const int row = r0 + threadIdx.x;
      s_lse[buf * kTile + threadIdx.x] = row < p.sq ? lse[row] * kLog2e : INFINITY;
      s_delta[buf * kTile + threadIdx.x] = row < p.sq ? delta[row] : 0.f;
    }
  };

  load_rows<D>(s_k, p.k, b, h, k0, p.n_keys, key_ok);
  load_rows<D>(s_v, p.v, b, h, k0, p.n_keys, key_ok);
  cp_async_commit();
  issue_q(0, 0);
  // This thread's two keys: masked ones add -inf to P's exponent.
  float kbias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + w16 + g + 8 * r;
    kbias[r] = key < p.n_keys && key_ok(key) ? 0.f : -INFINITY;
  }
  cp_async_wait<1>();
  __syncthreads();
  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a<D>(ka, s_k, w16, lane);
  load_a<D>(va, s_v, w16, lane);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  }
  const int n_qt = (p.sq + kTile - 1) / kTile;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int buf = qt & 1;
    if (qt + 1 < n_qt) {
      issue_q(qt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t tq = s_q + buf * S::kTileBytes;
    const uint32_t tdo = s_do + buf * S::kTileBytes;
    const float* l2 = s_lse + buf * kTile;
    const float* dl = s_delta + buf * kTile;

    float s[8][4], dp[8][4];
    product_nt<D>(s, ka, tq, lane);    // S^T = K Q^T: keys x queries
    product_nt<D>(dp, va, tdo, lane);  // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        const float pv = ex2(fmaf(s[j][e], sl2, -l2[qc]) + kbias[e >> 1]);
        s[j][e] = pv;                       // P^T
        dp[j][e] = pv * (dp[j][e] - dl[qc]);  // dS^T
      }
    }
    product_nn<D>(dv, s, tdo, lane);  // dV += P^T dO
    product_nn<D>(dk, dp, tq, lane);  // dK += dS^T Q
    __syncthreads();
  }
  store_rows<D>(p.dv, b, h, k0 + w16, p.n_kv_rows, dv, 1.f, lane);
  store_rows<D>(p.dk, b, h, k0 + w16, p.n_kv_rows, dk, p.scale, lane);
}

// dQ of 64 queries of one (batch, head); grid (ceil(sq / 64), heads, batch).
template <int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(const __grid_constant__ BwdParams p) {
  using S = Smem<D>;
  extern __shared__ __align__(16) uint8_t bwd_smem[];
  const uint32_t base = sm90::smem_addr(bwd_smem);
  const uint32_t s_q = base;
  const uint32_t s_do = s_q + S::kTileBytes;
  const uint32_t s_k = s_do + S::kTileBytes;            // [2]
  const uint32_t s_v = s_k + 2 * S::kTileBytes;         // [2]
  float* s_bias = reinterpret_cast<float*>(bwd_smem + 6 * S::kTileBytes);  // [2][kTile]

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int w16 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int* ids = p.kv_ids == nullptr ? nullptr : p.kv_ids + static_cast<long long>(b) * p.n_keys;
  const long long row_base = (static_cast<long long>(b) * p.heads + h) * p.sq;
  const float* lse = p.lse + row_base;
  const float* delta = p.delta + row_base;
  const float sl2 = p.scale * kLog2e;

  auto key_ok = [&](int key) { return ids == nullptr || ids[key] == 0; };
  auto live = [&](int row) { return lse[row] != INFINITY; };
  auto any = [](int) { return true; };
  // The key tile kt: K and V (masked keys as zeros) and each key's bias
  // (0, or -inf for a masked key or one past the end) into buffer `buf`.
  auto issue_kv = [&](int kt, int buf) {
    const int r0 = kt * kTile;
    load_rows<D>(s_k + buf * S::kTileBytes, p.k, b, h, r0, p.n_keys, key_ok);
    load_rows<D>(s_v + buf * S::kTileBytes, p.v, b, h, r0, p.n_keys, key_ok);
    cp_async_commit();
    if (threadIdx.x < kTile) {
      const int key = r0 + threadIdx.x;
      s_bias[buf * kTile + threadIdx.x] = key < p.n_keys && key_ok(key) ? 0.f : -INFINITY;
    }
  };

  load_rows<D>(s_q, p.q, b, h, q0, p.sq, live);
  load_rows<D>(s_do, p.dout, b, h, q0, p.sq, any);
  cp_async_commit();
  issue_kv(0, 0);
  // This thread's two query rows: LSE in log2 units (+inf past the end)
  // and D.
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + w16 + g + 8 * r;
    l2[r] = row < p.sq ? lse[row] * kLog2e : INFINITY;
    dl[r] = row < p.sq ? delta[row] : 0.f;
  }
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qa[D / 16][4], doa[D / 16][4];
  load_a<D>(qa, s_q, w16, lane);
  load_a<D>(doa, s_do, w16, lane);

  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  }
  const int n_kt = (p.n_keys + kTile - 1) / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kt) {
      issue_kv(kt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t tk = s_k + buf * S::kTileBytes;
    const uint32_t tv = s_v + buf * S::kTileBytes;
    const float* kb = s_bias + buf * kTile;

    float s[8][4], dp[8][4];
    product_nt<D>(s, qa, tk, lane);    // S = Q K^T: queries x keys
    product_nt<D>(dp, doa, tv, lane);  // dP = dO V^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float pv = ex2(fmaf(s[j][e], sl2, -l2[r]) + kb[8 * j + 2 * t + (e & 1)]);
        dp[j][e] = pv * (dp[j][e] - dl[r]);  // dS
      }
    }
    product_nn<D>(dq, dp, tk, lane);  // dQ += dS K
    __syncthreads();
  }
  store_rows<D>(p.dq, b, h, q0 + w16, p.sq, dq, p.scale, lane);
}

// Launch the dQ kernel, then the dK/dV kernel, on `stream`; returns
// cudaGetLastError() after each, so a refused launch reaches the caller.
// The shared-memory attribute belongs to the current device, so it is set
// on every call.
template <int D>
inline int launch_bwd(const BwdParams& p, int batch, cudaStream_t stream) {
  constexpr int smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<D><<<dim3((p.sq + kRows - 1) / kRows, p.heads, batch), kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<D><<<dim3((p.n_kv_rows + kRows - 1) / kRows, p.heads, batch), kThreads, smem,
                   stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn_bwd
