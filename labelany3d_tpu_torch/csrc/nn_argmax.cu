// Nearest bank row by dot similarity, per query row, for Hopper (sm_90a).
//
// Replaces labelany3d_tpu/ops/reciprocal_nn.py::nn_argmax_tiled (the Pallas
// TPU kernel behind the matcher's reciprocal nearest-neighbour rounds). It
// computes the same function: for every query row, the index and the value
// of the highest dot product against the bank rows [0, n_real); ties go to
// the first maximum (jnp.argmax). Precision 'bf16' scores bf16-rounded
// operands with fp32 accumulation; 'bf16x3' splits each fp32 operand into a
// bf16 high and low part and sums hi*hi + hi*lo + lo*hi (near fp32).
//
// Operands. The query is (P, S, 32) fp32, the descriptor width zero-padded
// to 32; each block rounds its own rows once. The bank comes prepared by
// ops/reciprocal_nn.py::prepare_bank_for_nn, once per match and not once
// per block and launch: (P, Nb, 32) bf16 for 'bf16' (64-byte rows), or
// (P, Nb, 64) bf16 [hi | lo] for 'bf16x3' (128-byte rows). Rows at or
// beyond n_real are never read, so they may hold anything.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the
// registration path's full launch, 32 pairs x 4096 queries x 262144 bank
// rows x C = 24, is 1.65 TFLOP (1.67 ms) against 0.55 GB of operands
// (0.16 ms): operations, on the tensor cores. Two costs sit on top of that
// bound. The tensor cores take C padded to 32, two k-steps of 16 (2.2 ms at
// peak). And the argmax needs at least one instruction a score on the SMs'
// own pipes: 34.4 G scores. The first port of this kernel reached 0.09 of
// the bound because every block re-read its pair's fp32 bank (69 GB a
// launch), split it to bf16 in every block, and waited for each tile's
// load before its products. The design:
//
//   * Block: 256 query rows of one pair and one chunk of the bank; grid
//     (query tiles, bank chunks, pairs), pair-major, so the blocks that
//     read one bank run side by side and share its tiles through L2. Four
//     consumer warpgroups own 64 rows each; a producer warpgroup, trimmed to
//     24 registers by setmaxnreg so the consumers get 112, issues every load
//     from one thread. 640 threads, one block an SM; the -Xptxas -v line
//     shows 96 registers at launch and no spills. At 256 rows a block
//     the full launch reads 8.6 GB of bank tiles (16 blocks a pair), mostly
//     from L2.
//   * Loads: TMA, bank tiles of 128 rows (8 KB, or 16 KB for bf16x3)
//     through a ring of 8 stages with a full and an empty mbarrier each.
//     The tensor map is 3-D (width, n_real, P): rows past n_real are never
//     read and arrive as zeros. 64-byte rows take the 64-byte swizzle and
//     its wgmma descriptor (layout type 2, 512-byte atoms); bf16x3's
//     128-byte [hi | lo] rows the 128-byte swizzle, so neither needs a
//     layout of its own, and bf16x3 has no 96-wide operand: hi*hi and
//     hi*lo are k-steps 0-1 and 2-3 of the row, lo*hi is k-steps 0-1 again
//     with the query's lo part.
//   * Products: wgmma m64n64k16 with the query as the A operand from
//     registers (rounded to bf16 once per block, in the A-fragment layout)
//     and the bank K-major from shared memory, two k-steps (six for
//     bf16x3), on one 64-row half of a tile at a time. Each warpgroup keeps
//     two accumulator sets: the products of one half run while the scores
//     of the other are folded.
//   * Epilogue: per row and half tile, each thread takes the maximum of
//     its 16 scores and compares it once with its running best; only when
//     strictly larger does it look for the first column holding it.
//     Columns are visited in increasing order, so the strict > keeps the
//     first maximum across tiles. The maximum is taken on the score's bit
//     patterns as signed integers with Hopper's three-way integer maxima
//     (DPX, __vimax3_s32): eight instructions for 16 scores instead of 15
//     FMNMX, exact whenever the row has a score >= +0 (integer order is
//     float order there); a row whose scores are all negative falls back to
//     a tree of fmaxf. At the end the four threads of a row reduce (larger
//     value; on equal values, the lower index).
//   * Only the last tile is masked, to -inf: TMA fills rows past n_real
//     with zeros, and a zero row would beat every negative real score. It
//     is peeled off the loop, so the choice of a masked fold is a branch
//     and never puts a wgmma under a condition (which makes ptxas serialise
//     them all).
//   * Filling the card: when query tiles x pairs leave SMs idle (one pair
//     is 16 blocks), the bank is split into chunks of whole tiles, one a
//     block; each chunk writes its (best, index) to scratch and a second
//     small kernel merges them in chunk order by the same rule. The entry
//     point decides the split from the block shape and the card's SM count
//     (split_for); nn_argmax_chunks tells the caller how much scratch that
//     takes. At the path's 32-pair shapes (512 and 128 blocks) there is one
//     chunk and no merge.
//
// Where the time goes (scripts/nn_argmax_variants.py takes pieces out):
// the loads and products alone run at the tensor cores' rate for the
// padded k, the epilogue alone at the rate of the SMs' integer pipe, and
// together they take about the sum of the two: the folds overlap the
// products only in small part, so fewer epilogue instructions are what
// shortens the kernel. Tried and left out, each slower: two consumer
// warpgroups of 128 rows (232 registers), the query in shared memory (wgmma
// ss), a fixed turn order of the warpgroups (named barriers), one
// accumulator set a warpgroup, and a sign-bit filter that skips a row's
// tile when every score is below its best (x - best on the FMA pipe, the
// sign bits ANDed).

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kConsumerWGs = 4;                     // consumer warpgroups
constexpr int kRowsWG = 64;                         // query rows a warpgroup (the wgmma M)
constexpr int kBlockM = kConsumerWGs * kRowsWG;     // query rows a block
constexpr int kTileN = 128;                         // bank rows a tile (one TMA load)
constexpr int kSubN = 64;                           // bank rows a product (the wgmma N)
constexpr int kC = 32;                              // padded query width (fp32)
constexpr int kStages = 8;                          // bank ring depth
constexpr int kConsumers = 128 * kConsumerWGs;
constexpr int kThreads = kConsumers + 128;          // + the producer warpgroup
// Registers a thread. A block gets kThreads x kLaunchRegs at launch; the
// producer warpgroup gives all but kProducerRegs of its share to the
// consumers (setmaxnreg, in steps of 8).
constexpr int kLaunchRegs = (65536 / kThreads) & ~7;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs =
    ((kLaunchRegs * kThreads - 128 * kProducerRegs) / kConsumers) & ~7;
constexpr int kMaxSplit = 16;                       // most bank chunks a launch

template <bool kX3>
struct Layout {
  static constexpr int kRowBytes = (kX3 ? 2 * kC : kC) * 2;  // 64 or 128
  static constexpr int kTileBytes = kTileN * kRowBytes;     // 8 or 16 KB
  static constexpr int kSubBytes = kSubN * kRowBytes;
  // The ring, its barriers, and slack to align the base to 1024 bytes.
  static constexpr int kSmemBytes = kStages * kTileBytes + 16 * kStages + 1024;
};

struct Params {
  CUtensorMap bank;    // (width, n_real, P) bf16
  const float* query;  // (P, S, 32) fp32
  float* best;         // (chunks, P, S)
  int* idx;            // (chunks, P, S)
  int s;
  int pairs;
  int n_real;
  int n_tiles;         // tiles over n_real
  int tiles_per_chunk;
};

// D (64 x 64, fp32) (+)= A (64 x 16, bf16 registers) * B (16 x 64, smem,
// K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The scores of a warpgroup's 64 query rows against the 64 bank rows at
// `sub`. The descriptor advances 32 bytes (2 units) a k-step of 16 bf16.
template <bool kX3>
__device__ __forceinline__ void issue_sub(float (&acc)[32], const uint32_t (&qh)[2][4],
                                          const uint32_t (&ql)[2][4], uint32_t sub) {
  if constexpr (!kX3) {
    const uint64_t db = sw64_desc(sub);
    wgmma_m64n64k16_rs(acc, qh[0], db, 0);
    wgmma_m64n64k16_rs(acc, qh[1], db + 2, 1);
  } else {
    const uint64_t db = sw128_desc(sub);  // row: bank hi (k-steps 0-1), lo (2-3)
    wgmma_m64n64k16_rs(acc, qh[0], db, 0);      // hi * hi
    wgmma_m64n64k16_rs(acc, qh[1], db + 2, 1);
    wgmma_m64n64k16_rs(acc, qh[0], db + 4, 1);  // hi * lo
    wgmma_m64n64k16_rs(acc, qh[1], db + 6, 1);
    wgmma_m64n64k16_rs(acc, ql[0], db, 1);      // lo * hi
    wgmma_m64n64k16_rs(acc, ql[1], db + 2, 1);
  }
}

// Fold one sub-tile's 64 x 64 scores into the running (best, first index) of
// this thread's two rows. In the accumulator, element 4 j + 2 r + e is row
// r (g or g + 8) at column 8 j + 2 c + e; `col0` is the bank index of this
// thread's column 0 (2 c). Per row: the maximum of its 16 scores, one
// strict comparison with the running best and, only when larger, the first
// column holding it. Columns are visited in increasing order, so the strict
// > keeps the first maximum across tiles. With kMasked, columns at or past
// n_real read as -inf (they arrive as zeros, which would beat every
// negative score).
template <bool kMasked>
__device__ __forceinline__ void fold_sub(const float (&d)[32], int col0, int n_real,
                                         float (&best)[2], int (&bidx)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x[16];  // column 8 (i >> 1) + (i & 1) of row r
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      x[i] = d[4 * (i >> 1) + 2 * r + (i & 1)];
      if constexpr (kMasked) x[i] = col0 + 8 * (i >> 1) + (i & 1) < n_real ? x[i] : -INFINITY;
    }
    // The largest bit pattern as a signed integer, by eight three-way
    // integer maxima (DPX): when it is >= 0 the row has a score >= +0 and it
    // is the largest float; otherwise every score is negative, where integer
    // order is reversed, and a tree of fmaxf decides.
    int u[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) u[i] = __float_as_int(x[i]);
    const int a0 = __vimax3_s32(u[0], u[1], u[2]), a1 = __vimax3_s32(u[3], u[4], u[5]);
    const int a2 = __vimax3_s32(u[6], u[7], u[8]), a3 = __vimax3_s32(u[9], u[10], u[11]);
    const int a4 = __vimax3_s32(u[12], u[13], u[14]);
    const int mi = max(__vimax3_s32(a0, a1, a2), __vimax3_s32(a3, a4, u[15]));
    float m = __int_as_float(mi);
    if (mi < 0) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = fmaxf(x[2 * j], x[2 * j + 1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = fmaxf(v[j], v[j + 4]);
      m = fmaxf(fmaxf(v[0], v[2]), fmaxf(v[1], v[3]));
    }
    if (m > best[r]) {
      int pos = 0;
#pragma unroll
      for (int i = 15; i >= 0; --i) {
        if (x[i] == m) pos = 8 * (i >> 1) + (i & 1);
      }
      best[r] = m;
      bidx[r] = col0 + pos;
    }
  }
}

template <bool kX3>
__global__ void __launch_bounds__(kThreads, 1)
    nn_argmax_kernel(const __grid_constant__ Params prm) {
  using L = Layout<kX3>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = ring + kStages * L::kTileBytes;
  const uint32_t empty0 = full0 + 8 * kStages;

  const int q0 = blockIdx.x * kBlockM;
  const int chunk = blockIdx.y;
  const int p = blockIdx.z;
  const int t_begin = chunk * prm.tiles_per_chunk;
  const int n_t = min(prm.n_tiles, t_begin + prm.tiles_per_chunk) - t_begin;  // >= 1
  // Warpgroups whose rows all lie past S (the last query tile) leave at
  // once; the empty barriers count the others.
  const int active = min(kConsumerWGs, (prm.s - q0 + kRowsWG - 1) / kRowsWG);

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, 128 * active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer warpgroup: one thread issues every load, kStages tiles ahead.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      prefetch_map(&prm.bank);
      for (int kt = 0; kt < n_t; ++kt) {
        const int st = kt % kStages;
        // The stage's previous tile (kt - kStages) must be released first:
        // that is completion number kt / kStages of its empty barrier.
        if (kt >= kStages) mbar_wait(empty0 + 8 * st, ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * st, L::kTileBytes);
        tma_load_3d(ring + st * L::kTileBytes, &prm.bank, full0 + 8 * st, 0,
                    (t_begin + kt) * kTileN, p);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = threadIdx.x >> 7;
  if (wg >= active) return;
  const int t = threadIdx.x & 127;
  const int g = (t & 31) >> 2;
  const int c = t & 3;
  // This thread holds query rows row0 and row0 + 8.
  const int row0 = q0 + kRowsWG * wg + 16 * (t >> 5) + g;

  // A fragments (m16n8k16 layout per warp, which is wgmma's): register f
  // of k-step kk holds row (f & 1 ? +8), columns 16 kk + 2 c + (f & 2 ? 8)
  // and + 1. Rows past S are zeros.
  uint32_t qh[2][4], ql[2][4];
  const float* qp = prm.query + static_cast<long long>(p) * prm.s * kC;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int row = row0 + ((f & 1) ? 8 : 0);
      const int col = 16 * kk + 2 * c + ((f & 2) ? 8 : 0);
      float2 x = make_float2(0.f, 0.f);
      if (row < prm.s) x = *reinterpret_cast<const float2*>(qp + row * kC + col);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x.x, x.y);
      qh[kk][f] = pack_bf16(x.x, x.y);
      ql[kk][f] = pack_bf16(x.x - __bfloat162float(hi.x), x.y - __bfloat162float(hi.y));
    }
  }

  // Two accumulator sets: the products of one 64-row sub-tile of the bank
  // run while the other's scores are folded. Every step ends in a wait for
  // all products in flight, and no fold reads the set being written, so
  // ptxas keeps the wgmmas asynchronous (folding a set between its issue
  // and its wait would make it serialise every wgmma, C7514).
  float acc_a[32], acc_b[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_a[i] = acc_b[i] = 0.f;
  float best[2] = {-INFINITY, -INFINITY};
  int bidx[2] = {0, 0};
  const int k_first = t_begin * kTileN;
  const int n_real = prm.n_real;
  auto sub = [&](int kt, int half) {
    return ring + (kt % kStages) * L::kTileBytes + half * L::kSubBytes;
  };
  auto issue = [&](float (&acc)[32], uint32_t addr) {
    wgmma_fence();
    issue_sub<kX3>(acc, qh, ql, addr);
    wgmma_commit();
  };
  auto wait = [&](float (&acc)[32]) {
    wgmma_wait<0>();
    fence_regs(acc);
  };
  auto fold = [&](float (&acc)[32], int col0, auto masked) {
    fold_sub<decltype(masked)::value>(acc, col0, n_real, best, bidx);
  };
  auto fold_last = [&](float (&acc)[32], int col0) {
    if (col0 - 2 * c + kSubN > n_real) {
      fold(acc, col0, Flag<true>());
    } else {
      fold(acc, col0, Flag<false>());
    }
  };

  mbar_wait(full0, 0);
  issue(acc_a, sub(0, 0));
  wait(acc_a);
  // Every tile but the last, which alone can reach past n_real: its second
  // sub-tile's products beside its first's fold, release the stage, the
  // next tile's first sub-tile beside this tile's second fold.
  for (int kt = 0; kt + 1 < n_t; ++kt) {
    const int col0 = k_first + kt * kTileN + 2 * c;
    issue(acc_b, sub(kt, 1));
    fold(acc_a, col0, Flag<false>());
    wait(acc_b);
    mbar_arrive(empty0 + 8 * (kt % kStages));
    mbar_wait(full0 + 8 * ((kt + 1) % kStages), ((kt + 1) / kStages) & 1);
    issue(acc_a, sub(kt + 1, 0));
    fold(acc_b, col0 + kSubN, Flag<false>());
    wait(acc_a);
  }
  {
    const int col0 = k_first + (n_t - 1) * kTileN + 2 * c;
    issue(acc_b, sub(n_t - 1, 1));
    fold_last(acc_a, col0);
    wait(acc_b);
    fold_last(acc_b, col0 + kSubN);
  }

  // Reduce over the four threads of a row: larger value, then lower index.
  const long long out0 = (static_cast<long long>(chunk) * prm.pairs + p) * prm.s;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float b = best[r];
    int i = bidx[r];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, b, off);
      const int oi = __shfl_xor_sync(0xffffffffu, i, off);
      if (ob > b || (ob == b && oi < i)) {
        b = ob;
        i = oi;
      }
    }
    const int row = row0 + 8 * r;
    if (c == 0 && row < prm.s) {
      prm.best[out0 + row] = b;
      prm.idx[out0 + row] = i;
    }
  }
}

// Merge the chunks' (best, index) of each query row in chunk order: a
// strictly larger value wins, so equal values keep the earlier chunk's,
// the lower index.
__global__ void nn_argmax_merge(const float* __restrict__ part_best,
                                const int* __restrict__ part_idx, float* __restrict__ best,
                                int* __restrict__ idx, int rows, int chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  float b = part_best[i];
  int k = part_idx[i];
  for (int ch = 1; ch < chunks; ++ch) {
    const float v = part_best[static_cast<long long>(ch) * rows + i];
    if (v > b) {
      b = v;
      k = part_idx[static_cast<long long>(ch) * rows + i];
    }
  }
  best[i] = b;
  idx[i] = k;
}

template <bool kX3>
int launch(const Params& prm, int q_tiles, int chunks, cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      nn_argmax_kernel<kX3>, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<kX3>::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  nn_argmax_kernel<kX3><<<dim3(q_tiles, chunks, prm.pairs), kThreads, Layout<kX3>::kSmemBytes,
                          stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

struct Split {
  int chunks;           // bank chunks, one a block along grid y
  int tiles_per_chunk;  // bank tiles a chunk (the last may hold fewer)
};

// The bank split of a launch: enough chunks that query tiles x pairs x
// chunks fill `sms` SMs, at most one a bank tile and kMaxSplit in all. The
// path's 32-pair launches (512 and 128 blocks) get one chunk.
Split split_for(int pairs, int s, int n_real, int sms) {
  const int n_tiles = (n_real + kTileN - 1) / kTileN;
  const int blocks = (s + kBlockM - 1) / kBlockM * pairs;
  const int want = max(1, min(min(sms / blocks, n_tiles), kMaxSplit));
  const int per = (n_tiles + want - 1) / want;
  return {(n_tiles + per - 1) / per, per};
}

// The split on the current device, or chunks = 0 when its SM count cannot
// be read.
Split device_split(int pairs, int s, int n_real) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return {0, 0};
  }
  return split_for(pairs, s, n_real, sms);
}

}  // namespace

// Bank chunks nn_argmax_fwd runs on the current device for this shape
// (1: no scratch, no merge), or 0 if the device cannot be queried. The
// caller sizes part_idx and part_best (chunks, P, S) by it.
extern "C" int nn_argmax_chunks(int pairs, int s, int n_real) {
  if (pairs < 1 || s < 1 || n_real < 1) return 0;
  return device_split(pairs, s, n_real).chunks;
}

// C entry point (bound with ctypes). query (P, S, 32) fp32; bank (P, Nb,
// width) bf16 from prepare_bank_for_nn, width 32 for precision 0 (bf16) and
// 64 for precision 1 (bf16x3); both contiguous and 16-byte aligned. Outputs
// (P, S) int32 and fp32. When nn_argmax_chunks gives more than one chunk,
// their results go to part_idx and part_best (chunks, P, S) and a second
// kernel merges them. Launches on `stream`; returns cudaGetLastError(), or
// minus the CUresult of a tensor map that failed to encode.
extern "C" int nn_argmax_fwd(const void* query, const void* bank, void* idx, void* best,
                             void* part_idx, void* part_best, int pairs, int s, int n_bank,
                             int n_real, int width, int precision, void* stream) {
  const bool x3 = precision == 1;
  if ((precision != 0 && precision != 1) || width != (x3 ? 2 * kC : kC) || pairs < 1 ||
      pairs > 65535 || s < 1 || n_real < 1 || n_real > n_bank ||
      (reinterpret_cast<uintptr_t>(bank) & 15) || (reinterpret_cast<uintptr_t>(query) & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Split split = device_split(pairs, s, n_real);
  if (split.chunks < 1) return static_cast<int>(cudaErrorInvalidDevice);
  if (split.chunks > 1 && (part_idx == nullptr || part_best == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params prm;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(n_real),
                              static_cast<cuuint64_t>(pairs)};
  const cuuint64_t strides[2] = {2ull * width, 2ull * width * n_bank};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(width), kTileN, 1};
  const int err = encode_map(&prm.bank, bank, 3, dims, strides, box,
                             x3 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != 0) return err;
  prm.query = static_cast<const float*>(query);
  prm.best = static_cast<float*>(split.chunks > 1 ? part_best : best);
  prm.idx = static_cast<int*>(split.chunks > 1 ? part_idx : idx);
  prm.s = s;
  prm.pairs = pairs;
  prm.n_real = n_real;
  prm.n_tiles = (n_real + kTileN - 1) / kTileN;
  prm.tiles_per_chunk = split.tiles_per_chunk;
  const int q_tiles = (s + kBlockM - 1) / kBlockM;
  auto st = static_cast<cudaStream_t>(stream);
  int rc = x3 ? launch<true>(prm, q_tiles, split.chunks, st)
              : launch<false>(prm, q_tiles, split.chunks, st);
  if (rc != 0 || split.chunks == 1) return rc;
  const int rows = pairs * s;
  nn_argmax_merge<<<(rows + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part_best), static_cast<const int*>(part_idx),
      static_cast<float*>(best), static_cast<int*>(idx), rows, split.chunks);
  return static_cast<int>(cudaGetLastError());
}
