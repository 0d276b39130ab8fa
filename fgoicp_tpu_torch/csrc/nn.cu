// Exact nearest neighbour (min + argmin, and min only) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels fgoicp_tpu/ops/pallas_nn.py::nn_argmin
// (_kernel) and ::nn_min (_kernel_min).  For every query q and target points
// c_j it computes
//     d2 = (c_x - q_x)^2 + (c_y - q_y)^2 + (c_z - q_z)^2      (direct differences)
// and keeps the running minimum, starting from BIG = 1e10, with a strict `<`
// while targets are visited in increasing index.  That reproduces the Pallas
// kernel's tie rule (first index inside a target tile, strict `<` across
// tiles), i.e. the global first index of the minimum.
//
// Design.  One thread per query; the block stages TILE target points in
// shared memory (3 x 1024 f32 = 12 KB) and every thread of the block reads
// the same staged point at the same time (a broadcast, no bank conflicts).
//
// What bounds it on the card: f32 ALU work, about 8 flops per query-target
// pair (3 subtractions, 3 multiplies, 2 adds) plus a compare and a select,
// with FMA contraction disabled.  Memory traffic is negligible: each target
// tile is read once per block, each query once.  wgmma and TMA do not apply:
// distances stay off the tensor cores, because a norm-expansion product
// ||q||^2 + ||c||^2 - 2 q.c cancels catastrophically near zero and would
// change argmins (the exact-distance rule of ROADMAP.md).
//
// Rounding.  The distance is written with __fmul_rn/__fadd_rn, and the
// library is built with --fmad=false, so every product and sum is rounded on
// its own, in the same order as the plain PyTorch version
// (fgoicp_tpu_torch/ops/cuda_nn.py).  d2 and idx then agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;
constexpr float kBig = 1e10f;

__device__ __forceinline__ float sq_dist(float cx, float cy, float cz,
                                         float qx, float qy, float qz) {
  const float dx = __fsub_rn(cx, qx);
  const float dy = __fsub_rn(cy, qy);
  const float dz = __fsub_rn(cz, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

template <bool kWantIdx>
__global__ void __launch_bounds__(kThreads)
nn_kernel(const float* __restrict__ queries, const float* __restrict__ points,
          int m, int t, float* __restrict__ d2_out, int* __restrict__ idx_out) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < m;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = queries[3 * i + 0];
    qy = queries[3 * i + 1];
    qz = queries[3 * i + 2];
  }
  float best = kBig;
  int best_idx = 0;

  for (int base = 0; base < t; base += kTile) {
    const int n = min(kTile, t - base);
    for (int j = threadIdx.x; j < n; j += kThreads) {
      sx[j] = points[3 * (base + j) + 0];
      sy[j] = points[3 * (base + j) + 1];
      sz[j] = points[3 * (base + j) + 2];
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < n; ++j) {
        const float d2 = sq_dist(sx[j], sy[j], sz[j], qx, qy, qz);
        if (d2 < best) {
          best = d2;
          if (kWantIdx) best_idx = base + j;
        }
      }
    }
    __syncthreads();
  }
  if (live) {
    d2_out[i] = best;
    if (kWantIdx) idx_out[i] = min(best_idx, t - 1);
  }
}

}  // namespace

extern "C" {

// d2_out [m] f32, idx_out [m] i32; queries [m, 3], points [t, 3] f32,
// contiguous, on the device of `stream`.
int fgoicp_nn_argmin(const float* queries, const float* points, int m, int t,
                     float* d2_out, int* idx_out, cudaStream_t stream) {
  if (m > 0) {
    const int blocks = (m + kThreads - 1) / kThreads;
    nn_kernel<true><<<blocks, kThreads, 0, stream>>>(queries, points, m, t,
                                                      d2_out, idx_out);
  }
  return static_cast<int>(cudaGetLastError());
}

int fgoicp_nn_min(const float* queries, const float* points, int m, int t,
                  float* d2_out, cudaStream_t stream) {
  if (m > 0) {
    const int blocks = (m + kThreads - 1) / kThreads;
    nn_kernel<false><<<blocks, kThreads, 0, stream>>>(queries, points, m, t,
                                                       d2_out, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fgoicp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
