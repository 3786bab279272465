// Minimum-area yaw search for oriented box fitting, for Hopper (sm_90a).
//
// Replaces labelany3d_tpu/ops/boxfit_pallas.py::yaw_minarea_pallas (the
// Pallas TPU kernel _yaw_kernel). It computes the same function: per
// instance, for A yaw angles a*step on [0, pi/2) (step = (pi/2)/A), rotate
// the valid ground-plane points (u = x cos + z sin, w = -x sin + z cos), take
// the masked extents (invalid points read as the +-3e38 sentinels of the TPU
// kernel), the footprint area (u_max - u_min) * (w_max - w_min), and return
// argmin * step, the first minimum on ties.
//
// What bounds it on an H100 SXM (67 TFLOP/s fp32 outside the tensor cores,
// 3.35 TB/s): per instance A*N*(4 multiplies + 2 adds + 4 compares), about
// 10*A*N fp32 operations against 9*N bytes of input; at I = 16, N = 500,
// A = 512 that is 41 MFLOP (0.6 us) against 72 KB (0.02 us): operations.
// At this size a launch's own latency, a few microseconds, is the practical
// floor, not the bound.
//
// Design. The first port ran one block an instance (16 blocks on 132 SMs),
// each thread one angle over all N points with a branch on the mask per
// point. Here each instance is a cluster of 8 blocks, so the layout shape
// fills 128 SMs:
//   * every block stages only its instance's valid points, compacted in
//     shared memory (their order is free: extents are exact), so the inner
//     loop has no branch;
//   * a block owns A/8 angles; four neighbouring threads share one angle
//     and take every fourth point, then combine their extents with two
//     shuffles, so the area is the same fp32 value a single pass gives;
//   * each thread keeps the first least area of its angles, the block
//     reduces (smaller area, then lower angle), and block 0 of the cluster
//     reads the eight results from the others' shared memory (distributed
//     shared memory) and writes the yaw. One launch, no atomics, no
//     scratch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kMaxPoints = 4096;   // points staged in shared memory
constexpr int kMaxAngles = 1024;
constexpr int kCluster = 8;        // blocks an instance
constexpr int kThreads = 256;
constexpr int kSlices = 4;         // threads sharing one angle's points
constexpr int kAnglesPerPass = kThreads / kSlices;
constexpr int kWarps = kThreads / 32;

// (area, angle) pairs: the smaller area wins, equal areas the lower angle.
__device__ __forceinline__ void take_min(float& area, int& idx, float oa, int oi) {
  if (oa < area || (oa == area && oi < idx)) {
    area = oa;
    idx = oi;
  }
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    yaw_minarea_kernel(const float* __restrict__ points, const uint8_t* __restrict__ valid,
                       float* __restrict__ yaw, int n, int num_angles) {
  __shared__ float px[kMaxPoints];
  __shared__ float pz[kMaxPoints];
  __shared__ int count;
  __shared__ float warp_area[kWarps];
  __shared__ int warp_idx[kWarps];
  __shared__ float block_area;  // this block's result, read by block 0 of the cluster
  __shared__ int block_idx;

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int inst = blockIdx.y;
  const float* pts = points + static_cast<long long>(inst) * n * 2;
  const uint8_t* vm = valid + static_cast<long long>(inst) * n;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if (vm[i]) {
      const int k = atomicAdd(&count, 1);
      px[k] = pts[2 * i];
      pz[k] = pts[2 * i + 1];
    }
  }
  __syncthreads();
  const int cnt = count;

  const float step = 1.57079632679489661923f / static_cast<float>(num_angles);
  const int per_block = (num_angles + kCluster - 1) / kCluster;
  const int a_begin = static_cast<int>(rank) * per_block;
  const int a_end = min(num_angles, a_begin + per_block);
  const int slice = threadIdx.x % kSlices;
  float best = INFINITY;
  int best_a = INT_MAX;
  // Every lane runs every pass (the shuffles need the whole warp); lanes
  // past the block's last angle drop their result.
  for (int base = a_begin; base < a_end; base += kAnglesPerPass) {
    const int a = base + threadIdx.x / kSlices;
    const float ang = static_cast<float>(a) * step;
    const float c = cosf(ang);
    const float s = sinf(ang);
    float u_max = -kBig, u_min = kBig, w_max = -kBig, w_min = kBig;
    for (int i = slice; i < cnt; i += kSlices) {
      const float x = px[i];
      const float z = pz[i];
      const float u = x * c + z * s;
      const float w = -x * s + z * c;
      u_max = fmaxf(u_max, u);
      u_min = fminf(u_min, u);
      w_max = fmaxf(w_max, w);
      w_min = fminf(w_min, w);
    }
#pragma unroll
    for (int off = 1; off < kSlices; off <<= 1) {
      u_max = fmaxf(u_max, __shfl_xor_sync(0xffffffffu, u_max, off));
      u_min = fminf(u_min, __shfl_xor_sync(0xffffffffu, u_min, off));
      w_max = fmaxf(w_max, __shfl_xor_sync(0xffffffffu, w_max, off));
      w_min = fminf(w_min, __shfl_xor_sync(0xffffffffu, w_min, off));
    }
    const float area = (u_max - u_min) * (w_max - w_min);
    if (a < a_end) take_min(best, best_a, area, a);
  }

  // Block argmin: a warp's lanes, then the warps.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    take_min(best, best_a, __shfl_xor_sync(0xffffffffu, best, off),
             __shfl_xor_sync(0xffffffffu, best_a, off));
  }
  if (threadIdx.x % 32 == 0) {
    warp_area[threadIdx.x / 32] = best;
    warp_idx[threadIdx.x / 32] = best_a;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) take_min(best, best_a, warp_area[w], warp_idx[w]);
    block_area = best;
    block_idx = best_a;
  }
  // Block 0 of the cluster reads the other seven results from their
  // blocks' shared memory; the second sync keeps that memory alive until
  // it has.
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    for (unsigned r = 1; r < kCluster; ++r) {
      take_min(best, best_a, *cluster.map_shared_rank(&block_area, r),
               *cluster.map_shared_rank(&block_idx, r));
    }
    yaw[inst] = static_cast<float>(best_a) * step;
  }
  cluster.sync();
}

}  // namespace

// C entry point (bound with ctypes). points (I, N, 2) fp32 and valid (I, N)
// uint8, contiguous; yaw (I,) fp32. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int yaw_minarea_fwd(const void* points, const void* valid, void* yaw,
                               int instances, int n, int num_angles, void* stream) {
  if (instances < 1 || instances > 65535 || n < 1 || n > kMaxPoints || num_angles < 1 ||
      num_angles > kMaxAngles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  yaw_minarea_kernel<<<dim3(kCluster, instances), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const uint8_t*>(valid),
      static_cast<float*>(yaw), n, num_angles);
  return static_cast<int>(cudaGetLastError());
}
