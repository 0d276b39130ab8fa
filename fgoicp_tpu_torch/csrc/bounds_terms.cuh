// Per-point bound terms shared by the fused bound kernels for Hopper
// (bounds_lanes.cu, bounds_grid.cu, bounds_lanes_trimmed.cu).
//
// For one branch-and-bound node (rotation group g, translation t, translation
// radius gt) and every source point i:
//     q    = base[g, i] + t
//     m    = min(BIG, min_p ||c_p - q||^2)        direct differences, BIG = 1e10
//     d    = sqrt(max(m, 0))
//     ut_i = w_i * relu(d - gam_ub[g, i])^2
//     lt_i = w_i * relu(d - slack - gam_lb[g, i] - gt)^2
// These are the per-point terms of the Pallas kernels in
// fgoicp_tpu/ops/pallas_bounds.py (_kernel, _lane_kernel,
// _lane_kernel_trimmed).
//
// Design.  One block per node.  The proxies are staged in shared memory as
// float4 (all at once when P <= kPTile = 2048, 32 KB; in tiles otherwise) and
// read as broadcasts.  Each thread owns kPerThread source points per pass, so
// one 16-byte broadcast read of a proxy feeds kPerThread distance evaluations
// and the loop is held by the f32 ALU, not by shared-memory loads.
//
// What bounds these kernels on the card: f32 ALU work, about 8 flops per
// (source point, proxy) pair with FMA contraction disabled.  wgmma and TMA do
// not apply: distances stay off the tensor cores under the exact-distance
// rule of ROADMAP.md (the bounds must stay valid, lb <= SSE <= ub, and the
// norm-expansion form cancels near zero).
//
// Rounding.  __fmul_rn/__fadd_rn/__fsub_rn in the order of the plain PyTorch
// versions (fgoicp_tpu_torch/ops/cuda_bounds.py), the library built with
// --fmad=false, IEEE sqrtf: every term equals the plain version's bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace fgoicp {

constexpr float kBig = 1e10f;
constexpr int kPTile = 2048;   // proxies staged at once (32 KB of float4)
constexpr int kPerThread = 4;  // source points per thread per pass

__device__ __forceinline__ float sq_dist(const float4 c, float qx, float qy,
                                         float qz) {
  const float dx = __fsub_rn(c.x, qx);
  const float dy = __fsub_rn(c.y, qy);
  const float dz = __fsub_rn(c.z, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Proxies [p0, p0 + n) of prox [P, 3] into shared memory as float4.
__device__ __forceinline__ void stage_proxies(const float* __restrict__ prox,
                                              int p0, int n, float4* sp) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float* c = prox + 3 * static_cast<size_t>(p0 + j);
    sp[j] = make_float4(c[0], c[1], c[2], 0.f);
  }
}

// One node: its group's rows of base [ns, 3], gam_ub and gam_lb [ns], its
// translation and translation radius.
struct Node {
  const float* base;
  const float* gam_ub;
  const float* gam_lb;
  float tx, ty, tz, gt;
};

// Calls f(i, ut_i, lt_i) once for every source point i, on the thread that
// owns it.  Every thread of the block must call it.  When P <= kPTile the
// caller has staged all proxies in sp and synchronised; otherwise this
// re-stages them, with barriers, once per pass and tile.
template <typename F>
__device__ __forceinline__ void for_each_point_terms(
    const Node& nd, const float* __restrict__ w, float slack, int ns,
    const float* __restrict__ prox, int n_prox, float4* sp, F f) {
  const int stride = blockDim.x * kPerThread;
  for (int i0 = 0; i0 < ns; i0 += stride) {
    float qx[kPerThread], qy[kPerThread], qz[kPerThread], m[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = i0 + k * blockDim.x + threadIdx.x;
      qx[k] = qy[k] = qz[k] = 0.f;
      if (i < ns) {
        qx[k] = __fadd_rn(nd.base[3 * i + 0], nd.tx);
        qy[k] = __fadd_rn(nd.base[3 * i + 1], nd.ty);
        qz[k] = __fadd_rn(nd.base[3 * i + 2], nd.tz);
      }
      m[k] = kBig;
    }
    for (int p0 = 0; p0 < n_prox; p0 += kPTile) {
      const int n = min(kPTile, n_prox - p0);
      if (n_prox > kPTile) {
        __syncthreads();
        stage_proxies(prox, p0, n, sp);
        __syncthreads();
      }
      for (int j = 0; j < n; ++j) {
        const float4 c = sp[j];
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
          m[k] = fminf(m[k], sq_dist(c, qx[k], qy[k], qz[k]));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = i0 + k * blockDim.x + threadIdx.x;
      if (i < ns) {
        const float d = sqrtf(fmaxf(m[k], 0.f));
        const float wi = w[i];
        const float u = fmaxf(__fsub_rn(d, nd.gam_ub[i]), 0.f);
        const float v = fmaxf(
            __fsub_rn(__fsub_rn(__fsub_rn(d, slack), nd.gam_lb[i]), nd.gt),
            0.f);
        f(i, __fmul_rn(wi, __fmul_rn(u, u)), __fmul_rn(wi, __fmul_rn(v, v)));
      }
    }
  }
}

// Reduces a and b over the block with `op`; every thread gets both results.
// red_a / red_b hold one value per warp.  A caller that reduces again before
// every thread has read the results passes another pair of buffers.
template <typename T, typename Op>
__device__ __forceinline__ void block_all_reduce2(T& a, T& b, T* red_a,
                                                  T* red_b, Op op) {
  for (int off = 16; off > 0; off >>= 1) {
    a = op(a, __shfl_xor_sync(0xffffffffu, a, off));
    b = op(b, __shfl_xor_sync(0xffffffffu, b, off));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red_a[warp] = a;
    red_b[warp] = b;
  }
  __syncthreads();
  a = red_a[0];
  b = red_b[0];
  for (int k = 1; k < static_cast<int>(blockDim.x >> 5); ++k) {
    a = op(a, red_a[k]);
    b = op(b, red_b[k]);
  }
}

struct Sum {
  template <typename T>
  __device__ __forceinline__ T operator()(T x, T y) const { return x + y; }
};

struct Max {
  __device__ __forceinline__ float operator()(float x, float y) const {
    return fmaxf(x, y);
  }
};

// lb, ub of one node: the weighted term sums over all source points.  Used
// by the untrimmed lane and grid kernels (kThreads threads per block).
template <int kThreads>
__device__ __forceinline__ void node_bounds(const Node& nd,
                                            const float* __restrict__ w,
                                            float slack, int ns,
                                            const float* __restrict__ prox,
                                            int n_prox, float* lb_out,
                                            float* ub_out) {
  __shared__ float4 sp[kPTile];
  __shared__ float red_lb[kThreads / 32];
  __shared__ float red_ub[kThreads / 32];
  if (n_prox <= kPTile) {
    stage_proxies(prox, 0, n_prox, sp);
    __syncthreads();
  }
  float acc_lb = 0.f;
  float acc_ub = 0.f;
  for_each_point_terms(nd, w, slack, ns, prox, n_prox, sp,
                       [&](int, float ut, float lt) {
                         acc_ub = __fadd_rn(acc_ub, ut);
                         acc_lb = __fadd_rn(acc_lb, lt);
                       });
  block_all_reduce2(acc_lb, acc_ub, red_lb, red_ub, Sum());
  if (threadIdx.x == 0) {
    *lb_out = acc_lb;
    *ub_out = acc_ub;
  }
}

}  // namespace fgoicp
