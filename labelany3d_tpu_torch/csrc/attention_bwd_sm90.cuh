// The Hopper (sm_90a) backward of the port's two attention kernels, shared
// by flash_attention.cu (K2, q, k, v in (B, S, H, D) read through strides)
// and packed_attention.cu (K1, the packed (B, Npad, 3W) qkv tensor, whose
// q, k and v are column ranges). Each of those files is a thin entry point
// with its own loader: the tensor maps it encodes on the host and the
// coordinates its tiles are loaded from and stored to, as for the forward.
// The two kernels, their pipelines and their masking are here, once.
//
// Replaces the backward of the Pallas TPU library's flash_attention, which
// labelany3d_tpu/ops/attention.py::flash_sdpa calls (library :125): its
// custom VJP runs _flash_attention_bwd_dkv (`pallas_call` :1121 of
// jax/experimental/pallas/ops/tpu/flash_attention.py) and
// _flash_attention_bwd_dq (`pallas_call` :1456), after computing
// di = rowsum(o * do) in XLA (:273). The split is the library's, and the
// row terms move into the first kernel:
//
//   dq_kernel    launched first. A block owns 128 queries of one (batch,
//                head). Its prologue computes each row's D = rowsum(dO o O)
//                in fp32 and the dead-row rule (below), and writes D and the
//                row's LSE (log2 units) to two (B, H, Sq padded to 64) fp32
//                scratch arrays. Its main loop streams key tiles: S = Q K^T,
//                P = exp2(S * scale * log2e - LSE * log2e), dP = dO V^T,
//                dS = P o (dP - D), dQ += dS K (times scale at the end).
//   dkdv_kernel  a block owns 128 keys and streams query tiles with their
//                slices of the scratch arrays: S^T = K Q^T, dP^T = V dO^T,
//                the same P^T and dS^T, dV += P^T dO and dK += dS^T Q.
//
// Nothing is carried between blocks and no block adds into another's
// output, so neither kernel uses atomics: a step repeats bit for bit. The
// row log-sum-exp LSE (natural log, the library's m + log(l)) is the
// forward's (attention_sm90.cuh). P and dS are rounded to bf16 before their
// products, and every product accumulates in fp32: the arithmetic of the
// library's kernels and of the JAX package's XLA VJP on bf16 operands.
//
// Masking. A key at or past `n_keys`, or whose id is non-zero, is masked; a
// query row with LSE = +inf is dead. The forward writes +inf for a row
// whose keys are all masked (its output is 0), and the dQ prologue sets it
// (with D = 0) for a row whose cotangent is all zero, which adds nothing to
// any gradient in exact arithmetic. TMA clips only the tensors' ends, so a
// masked or dead row inside a tensor arrives as it is, NaN included; hence:
//   * P and dS of a masked key or a dead row are set to 0 by a select,
//     never by adding -inf to a score (a NaN score minus inf is NaN);
//   * the dQ kernel zeroes the K rows of id-masked keys in shared memory
//     before dQ += dS K (0 times NaN is NaN), and the dK/dV kernel the Q
//     rows of dead queries before dK += dS^T Q; each only on tiles whose
//     flag (a warp vote) says they hold such a row;
//   * dK and dV rows of masked keys are written as zeros.
// Keys and query rows past the tensors' ends arrive as zeros. The dQ kernel
// skips key tiles that hold no live key (past `n_keys`, or all masked by
// ids: a warp vote over the tile's ids, the same in every warp); a dK/dV
// block whose keys are all masked writes zeros and loads nothing.
//
// Design. The forward's TMA + wgmma machinery (attention_sm90.cuh): 384
// threads, two consumer warpgroups of 64 rows each (the wgmma M) and a
// producer warpgroup trimmed by setmaxnreg to 24 registers a thread, so
// the consumers get 240; one thread of the producer issues every load.
// The operands of every product sit in shared memory as TMA wrote them
// (the 128-byte swizzle at d = 64, the 64-byte one at d = 32):
//   * dK/dV: K and V (128 x d) load once; Q, dO (64 x d, the tile height
//     suggested by four 64 x 64 fp32 accumulators a thread: S^T, dP^T, dK,
//     dV, 128 registers) and their LSE and D slices (bulk copies of 256
//     bytes) stream through a ring of kStages = 3 mbarrier stages (83 KB at
//     d = 64). S^T and dP^T: wgmma m64n64k16, both operands K-major from
//     shared memory. dV += P^T dO and dK += dS^T Q: wgmma m64n{d}k16 with
//     the A operand from registers (the S^T accumulators packed to bf16, as
//     the forward feeds P) and the B operand MN-major through the transpose
//     bit, as the forward reads V.
//   * dQ: Q, dO and O (128 x d) load once; K and V tiles of 128 keys stream
//     through three stages (144 KB at d = 64). S and dP: m64n128k16 from
//     shared memory (the forward's QK^T); dQ += dS K: m64n{d}k16 with dS
//     from registers and K MN-major (the forward's PV).
//   * Each consumer issues the gradient products of tile t and the score
//     products of tile t + 1 as one group (the forward's pattern), and the
//     two warpgroups take turns to issue their groups (named barriers, FA3's
//     ping-pong), so one's exponentials run under the other's products. The
//     dQ kernel reads the next tile's ids while its products run.
//   * Epilogue: the gradients in bf16 into the warpgroup's rows of its own
//     block tiles (their last reader was its final product), then one TMA
//     store each, which clips rows past the end.
// What was tried (scripts/attention_bwd_variants.py, on an H100): the turns
// save 1 to 3%; a ring of 2 stages costs 30%, one of 4 gains nothing; K and
// V held in registers as A fragments for S^T and dP^T (32 more registers a
// thread at d = 64, half the shared-memory reads of those products) gains
// nothing within noise; the exponentials alone are 4 to 9% of the time.
// Left out: a 128-row query tile in the dK/dV kernel (S^T and dP^T then
// need 128 accumulators a thread, 256 with dK and dV, over the 240 a
// thread has). ptxas reports 168 registers a thread, the launch's share;
// setmaxnreg then moves the producer's to the consumers, with no spills.
//
// What bounds it on an H100 SXM: the gradient needs five products of
// 2 * Sq * Sk * d a head (QK^T, dO V^T, dV, dK, dQ); the kernels execute
// seven (S and dP in both, as the library does), against reading q, k, v,
// o, do and writing dq, dk, dv once. At every path shape the tensor cores
// bound it (989 TFLOP/s bf16).

#pragma once

#include "attention_sm90.cuh"

namespace attn_bwd {

using namespace sm90;
using attn_sm90::ex2;
using attn_sm90::issue_qk;
using attn_sm90::st_shared_b32;
using attn_sm90::st_shared_zero16;
using attn_sm90::Tiles;

constexpr int kConsumerWGs = 2;                // consumer warpgroups, 64 rows each
constexpr int kBlockRows = 64 * kConsumerWGs;  // keys (dK/dV) or queries (dQ) a block owns
constexpr int kQTile = 64;                     // query rows of a streamed tile (dK/dV)
constexpr int kKTile = 128;                    // keys of a streamed tile (dQ)
constexpr int kStages = 3;                     // ring depth of both kernels
constexpr int kConsumers = 128 * kConsumerWGs;
constexpr int kThreads = kConsumers + 128;     // + the producer warpgroup
// 128 x 24 + 256 x 240 <= 65536.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
// Named barriers (0 is __syncthreads): 1 + wg ends warpgroup wg's
// epilogue; kZero follows the zeroing of masked rows in a shared tile;
// kTurn + wg is warpgroup wg's turn to issue its products.
constexpr int kZero = 1 + kConsumerWGs;
constexpr int kTurn = 2 + kConsumerWGs;
constexpr float kLog2e = 1.4426950408889634f;

// The sizes of both kernels' shared memory for head dim D.
template <int D>
struct Smem {
  static constexpr int kRowBytes = D * 2;
  static constexpr int kBlockBytes = kBlockRows * kRowBytes;  // a block's own Q, dO, O, K or V
  static constexpr int kQBytes = kQTile * kRowBytes;          // a streamed Q or dO tile
  static constexpr int kKBytes = kKTile * kRowBytes;          // a streamed K or V tile
  static constexpr int kRowTerms = 2 * kQTile * 4;            // a tile's LSE and D slices
  // dK/dV: K, V, Q[kStages], dO[kStages], the slices, kv_full and two
  // barriers a stage. dQ: Q, dO, O, K[kStages], V[kStages], q_full and two
  // barriers a stage. Plus slack to align the base to 1024 bytes.
  static constexpr int kDkdvBytes = 2 * kBlockBytes + kStages * (2 * kQBytes + kRowTerms) +
                                    8 * (2 * kStages + 1) + 1024;
  static constexpr int kDqBytes = 3 * kBlockBytes + 2 * kStages * kKBytes +
                                  8 * (2 * kStages + 1) + 1024;
};

// ---------------------------------------------------------------- PTX ---

// 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// D (64 x 64, fp32) = A (64 x 16, smem, K-major) * B (16 x 64, smem,
// K-major): the first k-step, which only writes D.
__device__ __forceinline__ void wgmma_m64n64k16_ss_first(float (&d)[32], uint64_t da,
                                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
        "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),
        "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// D (64 x 64, fp32) += A (64 x 16, smem, K-major) * B (16 x 64, smem,
// K-major).
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// acc (64 x 64) = A B^T over d: A and B 64-row tiles of d bf16, K-major in
// shared memory (S^T = K Q^T, dP^T = V dO^T). Both descriptors advance 32
// bytes a k-step inside the swizzle row.
template <int D>
__device__ __forceinline__ void issue_nt64(float (&acc)[32], uint64_t da, uint64_t db) {
  wgmma_m64n64k16_ss_first(acc, da, db);
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) wgmma_m64n64k16_ss(acc, da + 2 * kk, db + 2 * kk);
}

// acc (64 x d) += A (64 x 16 KSteps, bf16 registers: pairs 4 kk .. 4 kk + 3
// are the fragment of k-step kk) * B, B a tile of 16 KSteps rows of d bf16
// read MN-major (transpose bit): a k-step is 16 rows further.
template <int D, int KSteps>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2], const uint32_t (&a)[4 * KSteps],
                                         uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < KSteps; ++kk) {
    const uint64_t d = db + ((16 * D * 2) >> 4) * kk;
    if constexpr (D == 64) {
      attn_sm90::wgmma_m64n64k16_rs(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                                    d);
    } else {
      attn_sm90::wgmma_m64n32k16_rs(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                                    d);
    }
  }
}

// ------------------------------------------------------------- kernels ---
//
// A Loader provides (all device-side, const):
//   kHeadDim                          its head dim, 64 or 32 (a constant)
//   n_keys                            keys at or past this are masked
//   n_rows                            query rows
//   n_kv_rows                         rows of dK and dV (>= n_keys; the rest are zeros)
//   rows_pad                          n_rows rounded up to 64: the scratch arrays' rows
//   scale                             1 / sqrt(d)
//   key_ids(b)                        (n_keys) int32 ids, non-zero = masked, or null
//   lse                               (B, H, n_rows) fp32, the forward's LSE
//   l2s, dls                          (B, H, rows_pad) fp32 scratch: LSE in log2 units
//                                     (+inf = dead) and D, written by dq_kernel
//   prefetch()                        prefetch its tensor maps
//   load_q / load_do / load_o(dst, bar, row0, h, b)   TMA 64 rows x d at row0
//   load_k / load_v(dst, bar, row0, h, b)             TMA 128 rows x d at row0
//   store_dq / store_dk / store_dv(src, row0, h, b)   TMA-store 64 rows x d at row0
//
// In the accumulators of a consumer warpgroup, thread (warp w, lane) holds
// rows 16 w + g and 16 w + g + 8 (g = lane / 4) at columns 8 j + 2 c + {0,
// 1} (c = lane % 4) for j over the 8-column chunks: element 4 j + e is row
// (e >> 1), column e & 1. Packed to bf16 two at a time, pairs 4 kk .. 4 kk
// + 3 are the A fragment of the k-step over columns 16 kk .. 16 kk + 15.

// dK and dV of 128 keys of one (batch, head); grid (ceil(n_kv_rows / 128),
// heads, batch).
template <class Loader>
__global__ void __launch_bounds__(kThreads, 1) dkdv_kernel(const __grid_constant__ Loader ld) {
  constexpr int D = Loader::kHeadDim;
  using T = Tiles<D>;
  using S = Smem<D>;
  constexpr int kRowBytes = S::kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sk = base;
  const uint32_t sv = sk + S::kBlockBytes;
  const uint32_t sq0 = sv + S::kBlockBytes;                 // [kStages]
  const uint32_t sdo0 = sq0 + kStages * S::kQBytes;         // [kStages]
  const uint32_t rows0 = sdo0 + kStages * S::kQBytes;       // [kStages]: 64 LSE, then 64 D
  const uint32_t kv_full = rows0 + kStages * S::kRowTerms;
  const uint32_t full0 = kv_full + 8;
  const uint32_t empty0 = full0 + 8 * kStages;
  const float* rows = reinterpret_cast<const float*>(smem_raw + (rows0 - raw));

  const int k0 = blockIdx.x * kBlockRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_keys = ld.n_keys;
  const int n_rows = ld.n_rows;
  const int* ids = ld.key_ids(b);
  const int n_qt = (n_rows + kQTile - 1) / kQTile;
  const long long row_base = (static_cast<long long>(b) * gridDim.y + h) * ld.rows_pad;

  bool mine = false;
  if (threadIdx.x < kBlockRows) {
    const int key = k0 + threadIdx.x;
    mine = key < n_keys && (ids == nullptr || ids[key] == 0);
  }
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Whether any key of the block is live; if none, it writes zeros.
  const bool any_live = __syncthreads_or(mine);

  if (threadIdx.x >= kConsumers) {
    // Producer warpgroup: one thread issues every load, kStages tiles ahead.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers && any_live) {
      ld.prefetch();
      mbar_expect_tx(kv_full, 2 * S::kBlockBytes);
      ld.load_k(sk, kv_full, k0, h, b);
      ld.load_v(sv, kv_full, k0, h, b);
      for (int qt = 0; qt < n_qt; ++qt) {
        const int s = qt % kStages;
        // The stage's previous tile (qt - kStages) must be released first.
        if (qt >= kStages) mbar_wait(empty0 + 8 * s, ((qt / kStages) & 1) ^ 1);
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, 2 * S::kQBytes + S::kRowTerms);
        ld.load_q(sq0 + S::kQBytes * s, bar, qt * kQTile, h, b);
        ld.load_do(sdo0 + S::kQBytes * s, bar, qt * kQTile, h, b);
        const uint32_t r = rows0 + S::kRowTerms * s;
        bulk_load(r, ld.l2s + row_base + qt * kQTile, kQTile * 4, bar);
        bulk_load(r + kQTile * 4, ld.dls + row_base + qt * kQTile, kQTile * 4, bar);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // Consumer warpgroup `wg` owns keys k0 + 64 wg .. + 63: as rows of the
  // accumulators, this thread's keys 16 w + g and 16 w + g + 8 of them.
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  const int lane = t & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int row = (t >> 5) * 16 + g;  // row & 7 == g, as for row + 8
  const uint32_t sk_wg = sk + wg * 64 * kRowBytes;
  const uint32_t sv_wg = sv + wg * 64 * kRowBytes;
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + 64 * wg + row + 8 * r;
    key_ok[r] = key < n_keys && (ids == nullptr || ids[key] == 0);
  }
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  // dV and dK * scale in bf16 into this warpgroup's rows of the K and V
  // tiles, with the output maps' swizzle, masked keys as zeros; then one
  // TMA store each (rows past n_kv_rows are clipped).
  auto epilogue = [&]() {
    const float scale = ld.scale;
#pragma unroll
    for (int j = 0; j < T::kChunks; ++j) {
      const uint32_t col = (T::chunk(j, g) << 4) + 4 * c;
      const uint32_t lo = row * kRowBytes + col;
      const uint32_t hi = (row + 8) * kRowBytes + col;
      st_shared_b32(sv_wg + lo, key_ok[0] ? pack_bf16(dv[4 * j], dv[4 * j + 1]) : 0u);
      st_shared_b32(sv_wg + hi, key_ok[1] ? pack_bf16(dv[4 * j + 2], dv[4 * j + 3]) : 0u);
      st_shared_b32(sk_wg + lo,
                    key_ok[0] ? pack_bf16(dk[4 * j] * scale, dk[4 * j + 1] * scale) : 0u);
      st_shared_b32(sk_wg + hi,
                    key_ok[1] ? pack_bf16(dk[4 * j + 2] * scale, dk[4 * j + 3] * scale) : 0u);
    }
    fence_async_shared();
    named_sync(1 + wg, 128);
    if (t == 0 && k0 + 64 * wg < ld.n_kv_rows) {
      ld.store_dk(sk_wg, k0 + 64 * wg, h, b);
      ld.store_dv(sv_wg, k0 + 64 * wg, h, b);
      tma_store_wait();
    }
  };
  if (!any_live) {
    epilogue();
    return;
  }

  const float sl2 = ld.scale * kLog2e;
  float st[32], dpt[32];   // S^T then P^T; dP^T then dS^T (fp32)
  uint32_t pa[16], dsa[16];  // P^T and dS^T in bf16: the A operands of dV and dK

  // Wait for query tile qt; if it holds dead rows (LSE = +inf) inside the
  // tensor, zero their Q rows before any product reads them (every warp
  // takes the same vote).
  auto arrive = [&](int qt) {
    const int s = qt % kStages;
    mbar_wait(full0 + 8 * s, (qt / kStages) & 1);
    const float* l2 = rows + s * (S::kRowTerms / 4);
    const int q = qt * kQTile + lane;
    const bool dead = (l2[lane] == INFINITY && q < n_rows) ||
                      (l2[lane + 32] == INFINITY && q + 32 < n_rows);
    if (__any_sync(0xffffffffu, dead)) {
      const uint32_t tq = sq0 + S::kQBytes * s;
      for (int i = threadIdx.x; i < kQTile * T::kChunks; i += kConsumers) {
        if (l2[i / T::kChunks] == INFINITY) {
          st_shared_zero16(tq + (i / T::kChunks) * kRowBytes + (i % T::kChunks) * 16);
        }
      }
      fence_async_shared();
      named_sync(kZero, kConsumers);
    }
  };
  // S^T = K Q^T and dP^T = V dO^T for query tile qt.
  const uint64_t dk_desc = T::desc(sk_wg);
  const uint64_t dv_desc = T::desc(sv_wg);
  auto issue_scores = [&](int qt) {
    const int s = qt % kStages;
    issue_nt64<D>(st, dk_desc, T::desc(sq0 + S::kQBytes * s));
    issue_nt64<D>(dpt, dv_desc, T::desc(sdo0 + S::kQBytes * s));
  };
  // dV += P^T dO and dK += dS^T Q for query tile qt.
  auto issue_grads = [&](int qt) {
    const int s = qt % kStages;
    issue_rs<D, kQTile / 16>(dv, pa, T::desc(sdo0 + S::kQBytes * s));
    issue_rs<D, kQTile / 16>(dk, dsa, T::desc(sq0 + S::kQBytes * s));
  };
  // P^T and dS^T of tile qt from its LSE and D slices, packed to bf16. A
  // masked key (this thread's rows) or a dead query (the columns) gets 0.
  auto softmax = [&](int qt) {
    const float* l2 = rows + (qt % kStages) * (S::kRowTerms / 4);
    const float* dl = l2 + kQTile;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i >> 2) + 2 * c + (i & 1);
      const float lv = l2[col];
      const bool keep = key_ok[(i >> 1) & 1] && lv != INFINITY;
      const float p = ex2(fmaf(st[i], sl2, -lv));
      const float ds = p * (dpt[i] - dl[col]);
      st[i] = keep ? p : 0.f;
      dpt[i] = keep ? ds : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      pa[i] = pack_bf16(st[2 * i], st[2 * i + 1]);
      dsa[i] = pack_bf16(dpt[2 * i], dpt[2 * i + 1]);
    }
  };

  // The two warpgroups take turns to issue their products, so that one's
  // exponentials run while the other's products do (FA3's ping-pong):
  // warpgroup 1 lets 0 go first, and passes no turn after its last group.
  auto my_turn = [&]() { named_sync(kTurn + wg, kConsumers); };
  auto pass_turn = [&]() { named_arrive(kTurn + 1 - wg, kConsumers); };

  mbar_wait(kv_full, 0);
  arrive(0);
  if (wg == 1) pass_turn();
  my_turn();
  wgmma_fence();
  issue_scores(0);
  wgmma_commit();
  pass_turn();
  wgmma_wait_all();
  fence_regs(st);
  fence_regs(dpt);
  // Every tile but the last: P^T and dS^T of tile qt, then its gradient
  // products with the score products of tile qt + 1, as one group. (A
  // wgmma issued under a condition would make the compiler serialise them
  // all, so the last tile is peeled off.)
  for (int qt = 0; qt + 1 < n_qt; ++qt) {
    softmax(qt);
    arrive(qt + 1);
    fence_regs(dk);
    fence_regs(dv);
    wgmma_fence();
    my_turn();
    issue_grads(qt);
    issue_scores(qt + 1);
    wgmma_commit();
    pass_turn();
    wgmma_wait_all();
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(st);
    fence_regs(dpt);
    mbar_arrive(empty0 + 8 * (qt % kStages));
  }
  softmax(n_qt - 1);
  fence_regs(dk);
  fence_regs(dv);
  wgmma_fence();
  my_turn();
  issue_grads(n_qt - 1);
  wgmma_commit();
  if (wg == 0) pass_turn();
  wgmma_wait_all();
  fence_regs(dk);
  fence_regs(dv);
  mbar_arrive(empty0 + 8 * ((n_qt - 1) % kStages));
  epilogue();
}

// dQ of 128 queries of one (batch, head), and their LSE and D rows in the
// scratch arrays; grid (ceil(n_rows / 128), heads, batch).
template <class Loader>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(const __grid_constant__ Loader ld) {
  constexpr int D = Loader::kHeadDim;
  using T = Tiles<D>;
  using S = Smem<D>;
  constexpr int kRowBytes = S::kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sdo = sq + S::kBlockBytes;
  const uint32_t so = sdo + S::kBlockBytes;
  const uint32_t sk0 = so + S::kBlockBytes;                 // [kStages]
  const uint32_t sv0 = sk0 + kStages * S::kKBytes;          // [kStages]
  const uint32_t q_full = sv0 + kStages * S::kKBytes;
  const uint32_t full0 = q_full + 8;
  const uint32_t empty0 = full0 + 8 * kStages;

  const int q0 = blockIdx.x * kBlockRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_keys = ld.n_keys;
  const int n_tiles = (n_keys + kKTile - 1) / kKTile;
  const int* ids = ld.key_ids(b);
  // Warpgroups whose 64 rows all lie past the end have nothing to do (the
  // last query block); the others are the consumers of this block.
  const int active = min(kConsumerWGs, (ld.n_rows - q0 + 63) / 64);
  const int consumers = 128 * active;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Key tile kt's flags, the same in every warp that asks: bit 0, it holds
  // a live key; bit 1, it holds a key inside the tensor that ids mask.
  auto scan = [&](int kt) -> uint32_t {
    if (ids == nullptr) return 1u;
    bool live = false, masked = false;
#pragma unroll
    for (int i = 0; i < kKTile / 32; ++i) {
      const int key = kt * kKTile + 32 * i + (threadIdx.x & 31);
      if (key < n_keys) {
        const bool m = ids[key] != 0;
        live |= !m;
        masked |= m;
      }
    }
    return (__any_sync(0xffffffffu, live) ? 1u : 0u) | (__any_sync(0xffffffffu, masked) ? 2u : 0u);
  };
  // The first live key tile at or after kt (n_tiles if none), its flags in `fl`.
  auto next_live = [&](int kt, uint32_t& fl) {
    for (; kt < n_tiles; ++kt) {
      fl = scan(kt);
      if (fl & 1u) break;
    }
    return kt;
  };

  if (threadIdx.x >= kConsumers) {
    // Producer warpgroup: its first warp walks the live key tiles, one
    // thread issues every load, kStages tiles ahead.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x < kConsumers + 32) {
      const bool leader = threadIdx.x == kConsumers;
      if (leader) {
        ld.prefetch();
        mbar_expect_tx(q_full, 3 * active * 64 * kRowBytes);
        for (int w = 0; w < active; ++w) {
          const uint32_t off = w * 64 * kRowBytes;
          ld.load_q(sq + off, q_full, q0 + 64 * w, h, b);
          ld.load_do(sdo + off, q_full, q0 + 64 * w, h, b);
          ld.load_o(so + off, q_full, q0 + 64 * w, h, b);
        }
      }
      uint32_t fl;
      int i = 0;
      for (int kt = next_live(0, fl); kt < n_tiles; kt = next_live(kt + 1, fl), ++i) {
        if (leader) {
          const int s = i % kStages;
          if (i >= kStages) mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
          mbar_expect_tx(full0 + 8 * s, 2 * S::kKBytes);
          ld.load_k(sk0 + S::kKBytes * s, full0 + 8 * s, kt * kKTile, h, b);
          ld.load_v(sv0 + S::kKBytes * s, full0 + 8 * s, kt * kKTile, h, b);
        }
        __syncwarp();
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // Consumer warpgroup `wg` owns query rows q0 + 64 wg .. + 63.
  const int wg = threadIdx.x >> 7;
  if (wg >= active) return;
  const int t = threadIdx.x & 127;
  const int g = (t & 31) >> 2;
  const int c = t & 3;
  const int row = (t >> 5) * 16 + g;  // row & 7 == g, as for row + 8
  const uint32_t sq_wg = sq + wg * 64 * kRowBytes;
  const uint32_t sdo_wg = sdo + wg * 64 * kRowBytes;
  const uint32_t so_wg = so + wg * 64 * kRowBytes;

  // Prologue: this thread's two rows' D = rowsum(dO o O) in fp32 (four
  // threads a row, each over chunks c, c + 4, ...) and the dead-row rule:
  // a row whose cotangent is all zero, or past the end, gets LSE = +inf
  // and D = 0. Both go to the scratch arrays for the dK/dV kernel.
  mbar_wait(q_full, 0);
  float l2[2], dl[2];
  {
    const long long fwd_base = (static_cast<long long>(b) * gridDim.y + h) * ld.n_rows;
    const long long row_base = (static_cast<long long>(b) * gridDim.y + h) * ld.rows_pad;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = row + 8 * r;
      float sum = 0.f;
      uint32_t nz = 0u;
#pragma unroll
      for (int j = c; j < T::kChunks; j += 4) {
        const uint32_t off = rr * kRowBytes + (T::chunk(j, g) << 4);
        const uint4 a = ld_shared_v4(sdo_wg + off);
        const uint4 o = ld_shared_v4(so_wg + off);
        const uint32_t av[4] = {a.x, a.y, a.z, a.w};
        const uint32_t ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av[e]));
          const float2 fo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ov[e]));
          sum = fmaf(fa.x, fo.x, sum);
          sum = fmaf(fa.y, fo.y, sum);
          nz |= static_cast<uint32_t>(fa.x != 0.f || fa.y != 0.f);
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      nz |= __shfl_xor_sync(0xffffffffu, nz, 1);
      nz |= __shfl_xor_sync(0xffffffffu, nz, 2);
      const int q = q0 + 64 * wg + rr;
      const float lse = q < ld.n_rows ? ld.lse[fwd_base + q] : INFINITY;
      const bool live = nz != 0u && lse != INFINITY;
      l2[r] = live ? lse * kLog2e : INFINITY;
      dl[r] = live ? sum : 0.f;
      if (c == 0) {
        ld.l2s[row_base + q] = l2[r];
        ld.dls[row_base + q] = dl[r];
      }
    }
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  // dQ * scale in bf16 into this warpgroup's rows of the Q tile, then one
  // TMA store (rows past n_rows are clipped).
  auto epilogue = [&]() {
    const float scale = ld.scale;
#pragma unroll
    for (int j = 0; j < T::kChunks; ++j) {
      const uint32_t col = (T::chunk(j, g) << 4) + 4 * c;
      st_shared_b32(sq_wg + row * kRowBytes + col,
                    pack_bf16(dq[4 * j] * scale, dq[4 * j + 1] * scale));
      st_shared_b32(sq_wg + (row + 8) * kRowBytes + col,
                    pack_bf16(dq[4 * j + 2] * scale, dq[4 * j + 3] * scale));
    }
    fence_async_shared();
    named_sync(1 + wg, 128);
    if (t == 0) {
      ld.store_dq(sq_wg, q0 + 64 * wg, h, b);
      tma_store_wait();
    }
  };
  uint32_t fl;
  int kt = next_live(0, fl);
  if (kt >= n_tiles) {
    // No live key: dQ is zero.
    epilogue();
    return;
  }

  const float sl2 = ld.scale * kLog2e;
  float sc[64], dp[64];  // S, then dS (fp32); dP
  uint32_t dsa[32];      // dS in bf16: the A operand of dQ

  // Wait for the key tile in ring slot i (tile kt, flags f); if ids mask
  // keys inside it, zero their K rows before any product reads them.
  auto arrive = [&](int kt, int i, uint32_t f) {
    const int s = i % kStages;
    mbar_wait(full0 + 8 * s, (i / kStages) & 1);
    if (f & 2u) {
      const uint32_t tk = sk0 + S::kKBytes * s;
      for (int x = threadIdx.x; x < kKTile * T::kChunks; x += consumers) {
        const int key = kt * kKTile + x / T::kChunks;
        if (key < n_keys && ids[key] != 0) {
          st_shared_zero16(tk + (x / T::kChunks) * kRowBytes + (x % T::kChunks) * 16);
        }
      }
      fence_async_shared();
      named_sync(kZero, consumers);
    }
  };
  const uint64_t dq_desc = T::desc(sq_wg);
  const uint64_t ddo_desc = T::desc(sdo_wg);
  // S = Q K^T and dP = dO V^T for the tile in ring slot i.
  auto issue_scores = [&](int i) {
    const int s = i % kStages;
    issue_qk<D>(sc, dq_desc, T::desc(sk0 + S::kKBytes * s));
    issue_qk<D>(dp, ddo_desc, T::desc(sv0 + S::kKBytes * s));
  };
  // dQ += dS K for the tile in ring slot i.
  auto issue_dq = [&](int i) {
    issue_rs<D, kKTile / 16>(dq, dsa, T::desc(sk0 + S::kKBytes * (i % kStages)));
  };
  // dS of tile kt, packed to bf16. A masked key (the columns) or a dead row
  // gets 0; only a tile with masked keys or past the end checks the keys.
  auto grad = [&](int kt, auto masked) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i >> 1) & 1;
      bool keep = l2[r] != INFINITY;
      if constexpr (decltype(masked)::value) {
        const int key = kt * kKTile + 8 * (i >> 2) + 2 * c + (i & 1);
        keep = keep && key < n_keys && (ids == nullptr || ids[key] == 0);
      }
      const float p = ex2(fmaf(sc[i], sl2, -l2[r]));
      const float ds = p * (dp[i] - dl[r]);
      sc[i] = keep ? ds : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) dsa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
  };
  auto grad_tile = [&](int kt, uint32_t f) {
    if ((f & 2u) || (kt + 1) * kKTile > n_keys) {
      grad(kt, Flag<true>());
    } else {
      grad(kt, Flag<false>());
    }
  };

  // The warpgroups take turns to issue their products, as in the dK/dV
  // kernel, when both are active.
  const bool turns = active == kConsumerWGs;
  auto my_turn = [&]() {
    if (turns) named_sync(kTurn + wg, kConsumers);
  };
  auto pass_turn = [&]() {
    if (turns) named_arrive(kTurn + 1 - wg, kConsumers);
  };

  int i = 0;
  arrive(kt, 0, fl);
  if (wg == 1) pass_turn();
  my_turn();
  wgmma_fence();
  issue_scores(0);
  wgmma_commit();
  pass_turn();
  uint32_t nfl = 0u;
  int nx = next_live(kt + 1, nfl);  // read the next tile's ids while the products run
  wgmma_wait_all();
  fence_regs(sc);
  fence_regs(dp);
  // Every live tile but the last: dS of tile kt, then its dQ product with
  // the score products of the next live tile, as one group.
  while (nx < n_tiles) {
    grad_tile(kt, fl);
    arrive(nx, i + 1, nfl);
    fence_regs(dq);
    wgmma_fence();
    my_turn();
    issue_dq(i);
    issue_scores(i + 1);
    wgmma_commit();
    pass_turn();
    uint32_t nnfl = 0u;
    const int nnx = next_live(nx + 1, nnfl);
    wgmma_wait_all();
    fence_regs(dq);
    fence_regs(sc);
    fence_regs(dp);
    mbar_arrive(empty0 + 8 * (i % kStages));
    kt = nx;
    fl = nfl;
    nx = nnx;
    nfl = nnfl;
    ++i;
  }
  grad_tile(kt, fl);
  fence_regs(dq);
  wgmma_fence();
  my_turn();
  issue_dq(i);
  wgmma_commit();
  if (wg == 0) pass_turn();
  wgmma_wait_all();
  fence_regs(dq);
  mbar_arrive(empty0 + 8 * (i % kStages));
  epilogue();
}

// Make the current device's primary context current on the calling
// thread. The backward runs on autograd's device thread, where nothing may
// have bound a context yet (PyTorch sets the device without creating one),
// and encoding a tensor map is a driver call that needs it: without this it
// fails with CUDA_ERROR_INVALID_CONTEXT. Call it before the maps are
// encoded; returns a cudaError_t.
inline int bind_context() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);  // initialises the context (CUDA 12)
  return static_cast<int>(err);
}

// Launch the dQ kernel, then the dK/dV kernel, on `stream` (the second
// reads the scratch rows the first writes); returns cudaGetLastError()
// after each, so a refused launch reaches the caller. The shared-memory
// attribute belongs to the current device, so it is set on every call.
template <class Loader>
inline int launch_bwd(const Loader& ld, int heads, int batch, cudaStream_t stream) {
  using S = Smem<Loader::kHeadDim>;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel<Loader>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         S::kDqBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<Loader><<<dim3((ld.n_rows + kBlockRows - 1) / kBlockRows, heads, batch), kThreads,
                      S::kDqBytes, stream>>>(ld);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkdv_kernel<Loader>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::kDkdvBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<Loader><<<dim3((ld.n_kv_rows + kBlockRows - 1) / kBlockRows, heads, batch),
                        kThreads, S::kDkdvBytes, stream>>>(ld);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn_bwd
