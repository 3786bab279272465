// The Hopper (sm_90a) main loop shared by the port's two flash-attention
// kernels: packed_attention.cu (K1, the packed (B, Npad, 3W) qkv tensor)
// and flash_attention.cu (K2, q, k, v in (B, S, H, D) read through
// strides). Each of those files is a thin entry point with its own loader:
// the tensor maps it encodes on the host and the coordinates its tiles are
// loaded from and stored to. Everything else -- the pipeline, both
// products, the softmax, the masking and the epilogue -- is here, once.
//
// The function, for head dim 64 or 32 in bf16: O = softmax(Q K^T / sqrt(d)) V
// with fp32 scores, an fp32 softmax and fp32 accumulation; P is rounded to
// bf16 before the PV product, as on the TPU. Keys at or past `n_keys`, and
// (K2) keys whose segment id is non-zero, are masked: their scores are -inf
// and their V rows never reach an output, whatever they hold.
//
// What bounds it on an H100 SXM: at the path shapes the tensor cores
// (4*Sq*Sk*d operations per head against 989 TFLOP/s bf16) and, at d = 64,
// just as much the exponentials (one per score on the SM's 16 MUFU lanes a
// clock, the same time per score as its 256 tensor-core operations). So the
// design keeps the tensor cores fed with no thread spent on loads, and
// keeps enough warps on an SM that one's softmax runs while another's
// products do:
//
//   * Block: 192 query rows of one (batch, head); grid (query tiles, heads,
//     batch). Three consumer warpgroups own 64 rows each (the wgmma M); a
//     producer warpgroup, trimmed to 24 registers a thread by setmaxnreg so
//     the consumers get 160, issues every load from one thread. 512
//     threads, one block an SM. In the last query tile, warpgroups whose
//     rows all lie past the end leave at once.
//   * Loads: TMA. Q once (192 x d bf16, 24 KB at d = 64); K and V tiles of
//     128 keys (16 KB each at d = 64) through a ring of kStages = 4 stages
//     with a full and an empty mbarrier per stage (152 KB of shared memory
//     in all at d = 64, 78 KB at d = 32), so the loads of the next tiles
//     overlap this tile's products. A row of d bf16 is one swizzle row: the
//     tensor maps use the 128-byte swizzle at d = 64 and the 64-byte one at
//     d = 32, which wgmma reads without bank conflicts, and clip at the
//     sequence ends: keys and query rows past the end arrive as zeros and
//     stores past it are dropped, so no thread ever computes a bound on a
//     load.
//   * S = Q K^T: wgmma m64n128k16, both operands K-major from shared
//     memory, d / 16 k-steps (four at d = 64, two at d = 32).
//   * Softmax: online, in fp32 registers, in the log2 domain (one FFMA and
//     one ex2 per score), with tree reductions; only the last key tile, or
//     every tile when segment ids are given, is masked. A row whose keys are
//     all masked so far keeps finite exp2 arguments and ends as zeros.
//   * O += P V: wgmma m64n{d}k16 with P as the A operand from registers (the
//     accumulator layout of S, packed to bf16, is the A-fragment layout) and
//     V read as an MN-major B operand (transpose bit), so nothing
//     transposes V. PV of tile t and QK^T of tile t + 1 go out as one block.
//   * Epilogue: O / l rounded to bf16 into the warpgroup's 64 rows of the Q
//     tile (same swizzle), then one TMA store per warpgroup, which clips
//     rows past the end. When the loader gives an LSE pointer (a forward
//     whose backward will run), each row's log-sum-exp in natural-log
//     units, m * scale + log(l) (the Pallas library's m + log(l)), goes to
//     an fp32 (B, H, n_rows) array; a row whose keys are all masked
//     (l = 0, output 0) gets +inf, which makes its P = 0 in the backward
//     (attention_bwd_sm90.cuh). The serving routes pass null and write
//     nothing.
//
// The head dim is a template parameter (Tiles<D>, D = 64 or 32); a
// Loader names its own (Loader::kHeadDim). At d = 32 the matcher's tiny
// ViT and decoder (stage 5's elevation matcher) take the same loop.
//
// What was tried and left out: two consumer warpgroups of 128-query blocks
// (fewer warps to hide the softmax's latencies, and 8.6% more padded work
// at Sq = 1296), with named-barrier turns between them or FA3's overlap of
// one warpgroup's softmax with its own PV. The compiler waits for every
// product in flight before the first write to S's registers, so that
// overlap needs S and P in separate registers: 64 more a thread than the
// 160 that three consumer warpgroups leave.
//
// The generic Hopper pieces (mbarriers, TMA, wgmma fences and descriptors,
// tensor-map encoding) are in sm90_common.cuh.

#pragma once

#include "sm90_common.cuh"

namespace attn_sm90 {

using namespace sm90;

constexpr int kConsumerWGs = 3;              // consumer warpgroups, 64 rows each
constexpr int kBlockM = 64 * kConsumerWGs;   // query rows per block
constexpr int kBlockN = 128;                 // keys per tile
constexpr int kStages = 4;                   // K/V ring depth
constexpr int kConsumers = 128 * kConsumerWGs;
constexpr int kThreads = kConsumers + 128;   // + the producer warpgroup
// Registers a thread: the producer warpgroup gives its share to the
// consumers (setmaxnreg): 128 x 24 + 384 x 160 <= 65536.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 160;
// Named barriers (0 is __syncthreads): 1 + wg ends warpgroup wg's
// epilogue; kZeroV follows the zeroing of masked V rows.
constexpr int kZeroV = 1 + kConsumerWGs;
constexpr int kBarrierBytes = 8 * (2 * kStages + 1);

// The sizes that follow from the head dim D (64 or 32).
template <int D>
struct Tiles {
  static_assert(D == 64 || D == 32, "the attention loop takes head dim 64 or 32");
  static constexpr int kHeadDim = D;
  static constexpr int kRowBytes = D * 2;             // 128 or 64: one swizzle row
  static constexpr int kChunks = kRowBytes / 16;      // 16-byte chunks a row
  static constexpr int kQBytes = kBlockM * kRowBytes;        // the Q tile
  static constexpr int kTileBytes = kBlockN * kRowBytes;     // one K or V tile
  static constexpr int kOut = D / 2;                  // O accumulators a thread
  // Q, then K[kStages], then V[kStages], then the barriers; plus slack to
  // align the base to 1024 bytes (the 128-byte swizzle's period; the
  // 64-byte one repeats every 512).
  static constexpr int kSmemBytes = kQBytes + 2 * kStages * kTileBytes + kBarrierBytes + 1024;

  // The wgmma descriptor of a tile written by TMA with this swizzle.
  static __device__ __forceinline__ uint64_t desc(uint32_t addr) {
    if constexpr (D == 64) {
      return sw128_desc(addr);
    } else {
      return sw64_desc(addr);
    }
  }
  // The swizzled 16-byte chunk of chunk j in a row whose index mod 8 is
  // r: the 128-byte swizzle XORs address bits 7-9 (the row mod 8) into
  // bits 4-6; the 64-byte one bits 7-8 (the row / 2 mod 4) into bits 4-5.
  static __device__ __forceinline__ uint32_t chunk(int j, int r) {
    return D == 64 ? (j ^ r) : (j ^ ((r >> 1) & 3));
  }
};

// The host's tensor-map swizzle for head dim D.
template <int D>
constexpr CUtensorMapSwizzle kSwizzle = D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                                : CU_TENSOR_MAP_SWIZZLE_64B;

// ---------------------------------------------------------------- PTX ---

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_zero16(uint32_t addr) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(addr), "r"(0u) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D (64 x 128, fp32) = A (64 x 16, smem, K-major) * B (16 x 128, smem,
// K-major): the first k-step, which only writes D.
__device__ __forceinline__ void wgmma_m64n128k16_ss_first(float (&d)[64], uint64_t da,
                                                          uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
        "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),
        "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]),
        "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]),
        "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]),
        "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// D (64 x 128, fp32) += A (64 x 16, smem, K-major) * B (16 x 128, smem,
// K-major).
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 registers) * B (16 x 64, smem,
// MN-major: transpose bit set).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// D (64 x 32, fp32) += A (64 x 16, bf16 registers) * B (16 x 32, smem,
// MN-major: transpose bit set).
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// Reduce v[0..15] with `op` as a tree of depth 4 (written out, so every
// index is a constant and v stays in registers).
template <class Op>
__device__ __forceinline__ float tree16(float (&v)[16], Op op) {
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = op(v[j], v[j + 8]);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = op(v[j], v[j + 4]);
#pragma unroll
  for (int j = 0; j < 2; ++j) v[j] = op(v[j], v[j + 2]);
  return op(v[0], v[1]);
}

// S = Q K^T for one warpgroup: 64 x 128, D / 16 k-steps of 16 over d. Both
// descriptors advance 32 bytes a k-step inside the swizzle row.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint64_t dq, uint64_t dk) {
  wgmma_m64n128k16_ss_first(sc, dq, dk);
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) wgmma_m64n128k16_ss(sc, dq + 2 * kk, dk + 2 * kk);
}

// ----------------------------------------------------------- main loop ---

// A Loader provides (all device-side, const):
//   kHeadDim                       its head dim, 64 or 32 (a constant)
//   n_keys, n_rows, scale_log2     keys to attend to; query rows that exist
//   key_ids(b)                     (n_keys) int32 ids, non-zero = masked, or null
//   prefetch()                     prefetch its tensor maps
//   load_q(dst, bar, q0, h, b)     TMA the kBlockM x d Q tile at row q0
//   load_kv(dk, dv, bar, k0, h, b) TMA the 128 x d K and V tiles at key k0
//   store_o(src, row0, h, b)       TMA-store a 64 x d output tile at row0
//   lse                            (B, H, n_rows) fp32 row log-sum-exp out, or null
template <class Loader>
__global__ void __launch_bounds__(kThreads, 1)
    attention_kernel(const __grid_constant__ Loader ld) {
  using T = Tiles<Loader::kHeadDim>;
  constexpr int kRowBytes = T::kRowBytes;
  constexpr int kQBytes = T::kQBytes;
  constexpr int kTileBytes = T::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk0 = base + kQBytes;
  const uint32_t sv0 = sk0 + kStages * kTileBytes;
  const uint32_t full0 = sv0 + kStages * kTileBytes;
  const uint32_t empty0 = full0 + 8 * kStages;
  const uint32_t q_full = empty0 + 8 * kStages;

  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_keys = ld.n_keys;
  const int n_tiles = (n_keys + kBlockN - 1) / kBlockN;
  // Warpgroups whose 64 rows all lie past the end have nothing to do (the
  // last query tile); the others are the consumers of this block.
  const int active = min(kConsumerWGs, (ld.n_rows - q0 + 63) / 64);
  const int consumers = 128 * active;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, consumers);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer warpgroup: one thread issues every load, kStages tiles ahead.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      ld.prefetch();
      mbar_expect_tx(q_full, kQBytes);
      ld.load_q(sq, q_full, q0, h, b);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % kStages;
        // The stage's previous tile (kt - kStages) must be released first:
        // that is completion number kt / kStages of its empty barrier.
        if (kt >= kStages) mbar_wait(empty0 + 8 * s, ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, 2 * kTileBytes);
        ld.load_kv(sk0 + kTileBytes * s, sv0 + kTileBytes * s, full0 + 8 * s, kt * kBlockN, h, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // Consumer warpgroup `wg` owns query rows q0 + 64 wg .. + 63. In the
  // accumulators, thread (warp w, lane) holds rows 16 w + g and 16 w + g + 8
  // (g = lane / 4) at columns 8 j + 2 c + {0, 1} (c = lane % 4) for j over
  // the 8-column chunks: element 4 j + e is row (e >> 1), column e & 1.
  // Each warpgroup alternates between its softmax and a block of products
  // (PV of tile t, QK^T of tile t + 1); three of them on an SM keep the
  // tensor cores and the exponential units busy in turn.
  const int wg = threadIdx.x >> 7;
  if (wg >= active) return;
  const int t = threadIdx.x & 127;
  const int g = (t & 31) >> 2;
  const int c = t & 3;
  const int* ids = ld.key_ids(b);
  const float sl2 = ld.scale_log2;

  // Segment ids: TMA brings a masked key's V row as it is, and p = 0 times
  // a NaN there would still be NaN, so the consumers zero those rows of the
  // tile before any one's PV.
  auto zero_masked_v = [&](int kt) {
    const int k0 = kt * kBlockN;
    const uint32_t sv = sv0 + kTileBytes * (kt % kStages);
    for (int i = threadIdx.x; i < kBlockN * T::kChunks; i += consumers) {
      const int key = k0 + i / T::kChunks;
      if (key < n_keys && ids[key] != 0) {
        st_shared_zero16(sv + (i / T::kChunks) * kRowBytes + (i % T::kChunks) * 16);
      }
    }
    fence_async_shared();
    named_sync(kZeroV, consumers);
  };

  float o[T::kOut];
#pragma unroll
  for (int i = 0; i < T::kOut; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running max of raw scores
  float l_run[2] = {0.f, 0.f};              // this thread's part of the row sums
  float sc[64];                             // S, then P in fp32
  uint32_t pa[32];                          // P in bf16, the A operand of PV

  // The softmax of tile kt, in place: S in `sc` becomes exp2(S * scale_log2
  // - m) in fp32, P is packed to bf16 into `pa`, O is rescaled and the
  // running max and row sums are updated. Reductions are trees, so no chain
  // of 32 dependent operations holds the warp up. Pair i of `pa` holds
  // elements 2 i, 2 i + 1 (row i & 1); pairs 4 kk .. 4 kk + 3 are the A
  // fragment of k-step kk (keys 16 kk .. 16 kk + 15).
  auto softmax = [&](int kt, auto masked) {
    if constexpr (decltype(masked)::value) {
      // Keys past the end (the last tile) and masked segment ids: -inf.
      const int k0 = kt * kBlockN;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * c + (i & 1);
        const bool keep = key < n_keys && (ids == nullptr || ids[key] == 0);
        sc[i] = keep ? sc[i] : -INFINITY;
      }
    }
    float m_ref[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]);
      float mx = tree16(v, [](float a, float b) { return fmaxf(a, b); });
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      // Guard the all-masked case: keep exp2() arguments finite.
      m_ref[r] = m_new == -INFINITY ? 0.f : m_new * sl2;
      alpha[r] = ex2(m_run[r] * sl2 - m_ref[r]);  // 0 while m_run is -inf
      m_run[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = ex2(fmaf(sc[i], sl2, -m_ref[(i >> 1) & 1]));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = sc[4 * j + 2 * r] + sc[4 * j + 2 * r + 1];
      l_run[r] = l_run[r] * alpha[r] + tree16(v, [](float a, float b) { return a + b; });
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
#pragma unroll
    for (int i = 0; i < T::kOut; ++i) o[i] *= alpha[(i >> 1) & 1];
  };
  // The last tile needs the key-bound mask; with segment ids, every tile.
  auto softmax_tile = [&](int kt) {
    if (ids != nullptr || (kt + 1) * kBlockN > n_keys) {
      softmax(kt, Flag<true>());
    } else {
      softmax(kt, Flag<false>());
    }
  };

  // O += P V for tile kt: eight k-steps of 16 keys (16 rows of V apart).
  auto issue_pv = [&](int kt) {
    const uint64_t dv = T::desc(sv0 + kTileBytes * (kt % kStages));
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint64_t db = dv + (16 * kRowBytes >> 4) * kk;
      if constexpr (T::kHeadDim == 64) {
        wgmma_m64n64k16_rs(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3], db);
      } else {
        wgmma_m64n32k16_rs(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3], db);
      }
    }
  };

  // QK^T of tile 0.
  mbar_wait(q_full, 0);
  const uint32_t sq_wg = sq + wg * (kRowBytes * 64);
  const uint64_t dq = T::desc(sq_wg);
  mbar_wait(full0, 0);
  if (ids != nullptr) zero_masked_v(0);
  wgmma_fence();
  issue_qk<T::kHeadDim>(sc, dq, T::desc(sk0));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(sc);

  // Every tile but the last: softmax of tile kt, then PV of tile kt with
  // QK^T of tile kt + 1. (Issuing a wgmma under a condition would make the
  // compiler serialise them all, so the last tile is peeled off.)
  for (int kt = 0; kt + 1 < n_tiles; ++kt) {
    const int nx = kt + 1;
    softmax_tile(kt);
    mbar_wait(full0 + 8 * (nx % kStages), (nx / kStages) & 1);
    if (ids != nullptr) zero_masked_v(nx);
    fence_regs(o);
    wgmma_fence();
    issue_pv(kt);
    issue_qk<T::kHeadDim>(sc, dq, T::desc(sk0 + kTileBytes * (nx % kStages)));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(sc);
    mbar_arrive(empty0 + 8 * (kt % kStages));
  }
  // The last tile: softmax and PV.
  softmax_tile(n_tiles - 1);
  fence_regs(o);
  wgmma_fence();
  issue_pv(n_tiles - 1);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(o);
  mbar_arrive(empty0 + 8 * ((n_tiles - 1) % kStages));

  // Epilogue: O / l in bf16 into this warpgroup's 64 rows of the Q tile
  // (its last reader was this warpgroup's final QK^T), with the swizzle of
  // the output tensor map, then one TMA store.
  float inv[2], lsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    lsum[r] = l;
    inv[r] = l > 0.f ? 1.f / l : 0.f;
  }
  const int row = (t >> 5) * 16 + g;  // row & 7 == g, as for row + 8
  if (ld.lse != nullptr && c == 0) {
    float* lse = ld.lse + (static_cast<long long>(b) * gridDim.y + h) * ld.n_rows;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = q0 + 64 * wg + row + 8 * r;
      if (q < ld.n_rows) {
        lse[q] = lsum[r] > 0.f ? (m_run[r] * sl2 + log2f(lsum[r])) * 0.6931471805599453f
                               : INFINITY;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < T::kChunks; ++j) {
    const uint32_t col = (T::chunk(j, g) << 4) + 4 * c;
    st_shared_b32(sq_wg + row * kRowBytes + col,
                  pack_bf16(o[4 * j] * inv[0], o[4 * j + 1] * inv[0]));
    st_shared_b32(sq_wg + (row + 8) * kRowBytes + col,
                  pack_bf16(o[4 * j + 2] * inv[1], o[4 * j + 3] * inv[1]));
  }
  fence_async_shared();
  named_sync(1 + wg, 128);
  if (t == 0) {
    ld.store_o(sq_wg, q0 + 64 * wg, h, b);
    tma_store_wait();
  }
}

// One launch on `stream`; returns cudaGetLastError() so a refused launch
// reaches the caller. The shared-memory attribute belongs to the current
// device, so it is set on every call (microseconds, beside a kernel of
// tens of them or more).
template <class Loader>
inline int launch(const Loader& ld, int q_tiles, int heads, int batch, cudaStream_t stream) {
  constexpr int smem = Tiles<Loader::kHeadDim>::kSmemBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      attention_kernel<Loader>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  attention_kernel<Loader><<<dim3(q_tiles, heads, batch), kThreads, smem, stream>>>(ld);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn_sm90
