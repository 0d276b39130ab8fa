// Fused per-lane branch-and-bound bounds for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// fgoicp_tpu/ops/pallas_bounds.py::fused_bounds_lanes (_lane_kernel), the hot
// operation of every pooled inner R^3 step.  For lane l with group
// g = gids[l] and every source point i:
//     q   = base[g, i] + t[l]
//     m   = min(BIG, min_p ||c_p - q||^2)        direct differences, BIG = 1e10
//     d   = sqrt(max(m, 0))
//     ub_l = sum_i w_i * relu(d - gam_ub[g, i])^2
//     lb_l = sum_i w_i * relu(d - slack - gam_lb[g, i] - gam_t[l])^2
// Every lane is computed, valid or not, as the TPU kernel does; masking by
// lane validity stays with the caller (ops/pool_frontier.py).
//
// Design.  One block per lane (the main path's 1024 lanes are ~8 blocks per
// SM on 132 SMs).  The block reads gids[l] itself, which replaces the TPU
// kernel's scalar prefetch.  Proxies are staged in shared memory (all of them
// at once when P <= kPTile = 2048, 24 KB; in tiles otherwise) and read as
// broadcasts.  Threads stride over the source points, each looping over the
// staged proxies in registers, then forming its two weighted relu^2 terms; a
// warp-shuffle plus shared-memory reduction writes lb[l] and ub[l].
//
// What bounds it on the card: f32 ALU work, about 8 flops per
// (source point, proxy) pair with FMA contraction disabled; memory traffic is
// negligible (a lane reads ns rows of base and gammas once, the proxies once
// per block).  wgmma and TMA do not apply: distances stay off the tensor
// cores under the exact-distance rule of ROADMAP.md, because the bounds must
// stay valid (lb <= SSE <= ub) and the norm-expansion form cancels near zero.
//
// Rounding.  Distances use __fmul_rn/__fadd_rn (and the library is built with
// --fmad=false) in the order of the plain PyTorch version
// (fgoicp_tpu_torch/ops/cuda_bounds.py), and sqrtf is IEEE-rounded without
// fast math.  Only the final sums over i run in another order than torch.sum.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPTile = 2048;
constexpr float kBig = 1e10f;

__device__ __forceinline__ float sq_dist(float cx, float cy, float cz,
                                         float qx, float qy, float qz) {
  const float dx = __fsub_rn(cx, qx);
  const float dy = __fsub_rn(cy, qy);
  const float dz = __fsub_rn(cz, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void load_proxies(const float* __restrict__ prox,
                                             int p0, int n, float* sx,
                                             float* sy, float* sz) {
  for (int j = threadIdx.x; j < n; j += kThreads) {
    sx[j] = prox[3 * (p0 + j) + 0];
    sy[j] = prox[3 * (p0 + j) + 1];
    sz[j] = prox[3 * (p0 + j) + 2];
  }
}

__global__ void __launch_bounds__(kThreads)
bounds_lanes_kernel(const float* __restrict__ base, const int* __restrict__ gids,
                    const float* __restrict__ t, const float* __restrict__ prox,
                    const float* __restrict__ gam_ub,
                    const float* __restrict__ gam_lb,
                    const float* __restrict__ gam_t, const float* __restrict__ w,
                    float slack, int n_groups, int ns, int n_prox,
                    float* __restrict__ lb_out, float* __restrict__ ub_out) {
  __shared__ float sx[kPTile];
  __shared__ float sy[kPTile];
  __shared__ float sz[kPTile];
  __shared__ float red_lb[kThreads / 32];
  __shared__ float red_ub[kThreads / 32];

  const int lane = blockIdx.x;
  // Out-of-range group ids clamp, as a TPU index map would.
  const int g = min(max(gids[lane], 0), n_groups - 1);
  const float tx = t[3 * lane + 0];
  const float ty = t[3 * lane + 1];
  const float tz = t[3 * lane + 2];
  const float gt = gam_t[lane];
  const float* brow = base + static_cast<size_t>(g) * ns * 3;
  const float* gub = gam_ub + static_cast<size_t>(g) * ns;
  const float* glb = gam_lb + static_cast<size_t>(g) * ns;

  const bool one_tile = n_prox <= kPTile;
  if (one_tile) {
    load_proxies(prox, 0, n_prox, sx, sy, sz);
    __syncthreads();
  }

  float acc_lb = 0.f;
  float acc_ub = 0.f;
  for (int i0 = 0; i0 < ns; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    const bool live = i < ns;
    float qx = 0.f, qy = 0.f, qz = 0.f;
    if (live) {
      qx = __fadd_rn(brow[3 * i + 0], tx);
      qy = __fadd_rn(brow[3 * i + 1], ty);
      qz = __fadd_rn(brow[3 * i + 2], tz);
    }
    float m = kBig;
    for (int p0 = 0; p0 < n_prox; p0 += kPTile) {
      const int n = min(kPTile, n_prox - p0);
      if (!one_tile) {
        __syncthreads();
        load_proxies(prox, p0, n, sx, sy, sz);
        __syncthreads();
      }
      if (live) {
        for (int j = 0; j < n; ++j) {
          m = fminf(m, sq_dist(sx[j], sy[j], sz[j], qx, qy, qz));
        }
      }
    }
    if (live) {
      const float d = sqrtf(fmaxf(m, 0.f));
      const float wi = w[i];
      const float u = fmaxf(__fsub_rn(d, gub[i]), 0.f);
      acc_ub = __fadd_rn(acc_ub, __fmul_rn(wi, __fmul_rn(u, u)));
      const float v = fmaxf(
          __fsub_rn(__fsub_rn(__fsub_rn(d, slack), glb[i]), gt), 0.f);
      acc_lb = __fadd_rn(acc_lb, __fmul_rn(wi, __fmul_rn(v, v)));
    }
  }

  acc_lb = warp_sum(acc_lb);
  acc_ub = warp_sum(acc_ub);
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    red_lb[warp] = acc_lb;
    red_ub[warp] = acc_ub;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s_lb = 0.f, s_ub = 0.f;
    for (int k = 0; k < kThreads / 32; ++k) {
      s_lb += red_lb[k];
      s_ub += red_ub[k];
    }
    lb_out[lane] = s_lb;
    ub_out[lane] = s_ub;
  }
}

}  // namespace

extern "C" {

// base [G, ns, 3], gids [L] i32, t [L, 3], proxies [P, 3], gam_ub/gam_lb
// [G, ns], gam_t [L], w [ns] (f32 unless noted, contiguous, on the device of
// `stream`) -> lb_out, ub_out [L] f32.
int fgoicp_bounds_lanes(const float* base, const int* gids, const float* t,
                        const float* proxies, const float* gam_ub,
                        const float* gam_lb, const float* gam_t, const float* w,
                        float slack, int n_groups, int ns, int n_prox, int lanes,
                        float* lb_out, float* ub_out, cudaStream_t stream) {
  if (lanes > 0) {
    bounds_lanes_kernel<<<lanes, kThreads, 0, stream>>>(
        base, gids, t, proxies, gam_ub, gam_lb, gam_t, w, slack, n_groups, ns,
        n_prox, lb_out, ub_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
