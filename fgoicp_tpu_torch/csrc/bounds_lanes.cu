// Fused per-lane branch-and-bound bounds for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// fgoicp_tpu/ops/pallas_bounds.py::fused_bounds_lanes (_lane_kernel), the hot
// operation of every pooled inner R^3 step.  For lane l with group
// g = gids[l], translation t[l] and radius gam_t[l], with the per-point terms
// ut_i, lt_i of bounds_terms.cuh:
//     ub_l = sum_i ut_i        lb_l = sum_i lt_i
// Every lane is computed, valid or not, as the TPU kernel does; masking by
// lane validity stays with the caller (ops/pool_frontier.py).
//
// Design.  One block per lane (the main path's 1024 lanes are ~8 blocks per
// SM on 132 SMs).  The block reads gids[l] itself, which replaces the TPU
// kernel's scalar prefetch.  The nearest-proxy search is bounds_terms.cuh's
// box-pruned one over the Morton-bucketed proxies, exact bit for bit; the
// block reduction is shared too.  What bounds it: the (point, proxy) pairs
// that the pruning leaves plus the (point, box) tests, f32 ALU work; memory
// traffic is negligible (a lane reads ns rows of base and gammas once, the
// buckets once per block).
//
// Only the final sums over i run in another order than torch.sum in the
// plain version (fgoicp_tpu_torch/ops/cuda_bounds.py): they follow the
// source order.

#include "bounds_terms.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bounds_lanes_kernel(const float* __restrict__ base, const int* __restrict__ gids,
                    const float* __restrict__ t, fgoicp::Buckets bk,
                    const float* __restrict__ gam_ub,
                    const float* __restrict__ gam_lb,
                    const float* __restrict__ gam_t, const float* __restrict__ w,
                    float slack, int n_groups, int ns,
                    unsigned long long* counts, float* __restrict__ lb_out,
                    float* __restrict__ ub_out) {
  const int lane = blockIdx.x;
  // Out-of-range group ids clamp, as a TPU index map would.
  const size_t g = min(max(gids[lane], 0), n_groups - 1);
  const fgoicp::Node nd{base + g * ns * 3, gam_ub + g * ns, gam_lb + g * ns,
                        t[3 * lane + 0], t[3 * lane + 1], t[3 * lane + 2],
                        gam_t[lane]};
  fgoicp::node_bounds<kThreads>(nd, w, slack, ns, bk, lb_out + lane,
                                ub_out + lane, counts);
}

}  // namespace

extern "C" {

// base [G, ns, 3], gids [L] i32, t [L, 3], rows [n_buckets * 32, 3] and
// boxes [n_buckets, 6] (the bucketed proxies), order [ns] i32 (the source
// order, or null), gam_ub/gam_lb [G, ns], gam_t [L], w [ns] (f32 unless
// noted, contiguous, on the device of `stream`) -> lb_out, ub_out [L] f32.
// counts (u64 [2] or null) gets the pairs evaluated and the box tests added.
int fgoicp_bounds_lanes(const float* base, const int* gids, const float* t,
                        const float* rows, const float* boxes, const int* order,
                        const float* gam_ub, const float* gam_lb,
                        const float* gam_t, const float* w, float slack,
                        int n_groups, int ns, int n_buckets, int lanes,
                        unsigned long long* counts, float* lb_out,
                        float* ub_out, cudaStream_t stream) {
  if (lanes > 0) {
    const fgoicp::Buckets bk{rows, boxes, order, n_buckets};
    bounds_lanes_kernel<<<lanes, kThreads,
                          fgoicp::bucket_smem_bytes(n_buckets), stream>>>(
        base, gids, t, bk, gam_ub, gam_lb, gam_t, w, slack, n_groups, ns,
        counts, lb_out, ub_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
