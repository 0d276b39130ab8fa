// Fused grid branch-and-bound bounds for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// fgoicp_tpu/ops/pallas_bounds.py::fused_bounds (_kernel), which the grouped
// inner scheduler (ops/frontier.py through bounds.evaluate_bounds) runs every
// step.  For every rotation group g and translation node b, with
// t = t_centers[g, b], gt = gam_t[g, b] and the per-point terms ut_i, lt_i
// of bounds_terms.cuh:
//     ub[g, b] = sum_i ut_i        lb[g, b] = sum_i lt_i
// The TPU kernel accumulates over 512-wide source tiles along a sequential
// grid axis; here one block owns a whole (g, b) node and loops over the
// source points itself, so nothing carries between blocks.
//
// Design.  One block per (g, b): the grouped path's G 256 x B 32 = 8,192
// blocks fill the 132 SMs many times over.  The nearest-proxy search is
// bounds_terms.cuh's box-pruned one, exact bit for bit, shared with
// bounds_lanes.cu with the block reduction.  What bounds it: the (point,
// proxy) pairs that the pruning leaves plus the (point, box) tests, f32 ALU
// work; each block reads its group's ns rows of base and gammas and the
// buckets once.
//
// Only the final sums over i run in another order than torch.sum in the
// plain version (fgoicp_tpu_torch/ops/cuda_bounds.py::fused_bounds_plain):
// they follow the source order.

#include "bounds_terms.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bounds_grid_kernel(const float* __restrict__ base,
                   const float* __restrict__ t_centers, fgoicp::Buckets bk,
                   const float* __restrict__ gam_ub,
                   const float* __restrict__ gam_lb,
                   const float* __restrict__ gam_t,
                   const float* __restrict__ w, float slack, int n_trans,
                   int ns, unsigned long long* counts,
                   float* __restrict__ lb_out, float* __restrict__ ub_out) {
  const int node = blockIdx.x;  // g * B + b
  const size_t g = node / n_trans;
  const fgoicp::Node nd{base + g * ns * 3, gam_ub + g * ns, gam_lb + g * ns,
                        t_centers[3 * node + 0], t_centers[3 * node + 1],
                        t_centers[3 * node + 2], gam_t[node]};
  fgoicp::node_bounds<kThreads>(nd, w, slack, ns, bk, lb_out + node,
                                ub_out + node, counts);
}

}  // namespace

extern "C" {

// base [G, ns, 3], t_centers [G, B, 3], rows [n_buckets * 32, 3] and boxes
// [n_buckets, 6] (the bucketed proxies), order [ns] i32 (the source order, or
// null), gam_ub/gam_lb [G, ns], gam_t [G, B], w [ns] (f32 unless noted,
// contiguous, on the device of `stream`) -> lb_out, ub_out [G, B] f32.
// counts (u64 [2] or null) gets the pairs evaluated and the box tests added.
int fgoicp_bounds_grid(const float* base, const float* t_centers,
                       const float* rows, const float* boxes, const int* order,
                       const float* gam_ub, const float* gam_lb,
                       const float* gam_t, const float* w, float slack,
                       int n_groups, int n_trans, int ns, int n_buckets,
                       unsigned long long* counts, float* lb_out,
                       float* ub_out, cudaStream_t stream) {
  const long long nodes = static_cast<long long>(n_groups) * n_trans;
  if (nodes > 0) {
    const fgoicp::Buckets bk{rows, boxes, order, n_buckets};
    bounds_grid_kernel<<<static_cast<unsigned>(nodes), kThreads,
                         fgoicp::bucket_smem_bytes(n_buckets), stream>>>(
        base, t_centers, bk, gam_ub, gam_lb, gam_t, w, slack, n_trans, ns,
        counts, lb_out, ub_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
