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
// Design. The TPU kernel unrolls a block of 8 instances per grid step and
// holds the (N, A) projections in VMEM. Here one block serves one instance:
// its points and mask are staged once in shared memory, each thread owns
// one angle and loops over the points keeping four running extents in
// registers, and a shared-memory tree reduces (area, angle) pairs with the
// first-minimum rule. Nothing but the yaw per instance reaches device memory.
//
// What bounds it on an H100 SXM (67 TFLOP/s fp32 outside the tensor cores,
// 3.35 TB/s): per instance A*N*(4 multiplies + 2 adds + 4 compares), about
// 10*A*N fp32 operations against 12*N bytes of input; at I = 16, N = 500,
// A = 512 that is 41 MFLOP (0.6 us) against 96 KB (0.03 us): operations.
// At these sizes the launch itself is what a call costs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kMaxPoints = 4096;   // points staged in shared memory
constexpr int kMaxAngles = 1024;   // one thread per angle

__global__ void yaw_minarea_kernel(const float* __restrict__ points,
                                   const uint8_t* __restrict__ valid,
                                   float* __restrict__ yaw, int n, int num_angles) {
  __shared__ float px[kMaxPoints];
  __shared__ float pz[kMaxPoints];
  __shared__ uint8_t pv[kMaxPoints];
  __shared__ float red_area[kMaxAngles];
  __shared__ int red_idx[kMaxAngles];

  const int inst = blockIdx.x;
  const float* pts = points + (long long)inst * n * 2;
  const uint8_t* vm = valid + (long long)inst * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    px[i] = pts[2 * i];
    pz[i] = pts[2 * i + 1];
    pv[i] = vm[i];
  }
  __syncthreads();

  const float step = 1.57079632679489661923f / (float)num_angles;
  const int a = threadIdx.x;
  float area = INFINITY;
  if (a < num_angles) {
    const float ang = (float)a * step;
    const float c = cosf(ang);
    const float s = sinf(ang);
    float u_max = -kBig, u_min = kBig, w_max = -kBig, w_min = kBig;
    for (int i = 0; i < n; ++i) {
      if (!pv[i]) continue;
      const float x = px[i];
      const float z = pz[i];
      const float u = x * c + z * s;
      const float w = -x * s + z * c;
      u_max = fmaxf(u_max, u);
      u_min = fminf(u_min, u);
      w_max = fmaxf(w_max, w);
      w_min = fminf(w_min, w);
    }
    area = (u_max - u_min) * (w_max - w_min);
  }
  red_area[threadIdx.x] = area;
  red_idx[threadIdx.x] = a;
  __syncthreads();

  // Tree argmin over blockDim.x (a power of two) slots: smaller area wins,
  // equal areas the lower angle index.
  for (int half = blockDim.x / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      const float oa = red_area[threadIdx.x + half];
      const int oi = red_idx[threadIdx.x + half];
      const float ma = red_area[threadIdx.x];
      const int mi = red_idx[threadIdx.x];
      if (oa < ma || (oa == ma && oi < mi)) {
        red_area[threadIdx.x] = oa;
        red_idx[threadIdx.x] = oi;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) yaw[inst] = (float)red_idx[0] * step;
}

}  // namespace

// C entry point (bound with ctypes). points (I, N, 2) fp32 and valid (I, N)
// uint8, contiguous; yaw (I,) fp32. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int yaw_minarea_fwd(const void* points, const void* valid, void* yaw,
                               int instances, int n, int num_angles, void* stream) {
  if (instances < 1 || n < 1 || n > kMaxPoints || num_angles < 1 ||
      num_angles > kMaxAngles) {
    return (int)cudaErrorInvalidValue;
  }
  int threads = 32;
  while (threads < num_angles) threads <<= 1;
  yaw_minarea_kernel<<<instances, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(points), static_cast<const uint8_t*>(valid),
      static_cast<float*>(yaw), n, num_angles);
  return (int)cudaGetLastError();
}
