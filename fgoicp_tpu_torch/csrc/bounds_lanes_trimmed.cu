// Fused trimmed per-lane branch-and-bound bounds for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// fgoicp_tpu/ops/pallas_bounds.py::fused_bounds_lanes_trimmed
// (_lane_kernel_trimmed), which the pooled inner R^3 frontier runs every step
// of a trimmed registration.  For lane l (group g = gids[l], translation
// t[l], radius gam_t[l]) with the weighted per-point terms ut_i, lt_i of
// bounds_terms.cuh and n_drop the number of largest terms the trimmed
// objective leaves out:
//     ub_l = sum_i ut_i - max(drop_under(ut), 0)
//     lb_l = sum_i lt_i - max(drop_over(lt), 0)
// where drop_over / drop_under bracket the sum of the n_drop largest terms
// from above / below by 26 steps of threshold bisection
// (fgoicp_tpu/ops/bounds.py::_dropsum_bracket, modes "over" and "under"):
//     lo = 0, hi = max_i x_i
//     26 times: mid = 0.5 * (lo + hi); if count(x > mid) >= n_drop: lo = mid
//               else hi = mid
//     over:  T = lo;  under: T = hi
//     drop = sum(x_i > T ? x_i : 0) + (n_drop - count(x > T)) * lo
// Weights must be 0/1 (the engine trims plain sources only); a weight-0
// point has terms 0, which no threshold >= 0 counts.
//
// drop >= 0 for terms >= 0, so sum_i x_i - max(drop, 0) is formed as
//     sum(x_i <= T ? x_i : 0) - (n_drop - count(x > T)) * lo,
// equal in exact arithmetic and free of the cancellation of two large sums
// where most of a lane's total is dropped (the plain version's `kept_sum`).
//
// Design.  One block per lane; it loads its own gids[l].  The nearest-proxy
// search is bounds_terms.cuh's exact box-pruned one over the Morton-bucketed
// proxies, shared with the untrimmed kernels: it hands each point's terms to
// the thread that owns it, which writes them at the point's index into
// dynamic shared memory beside the staged buckets (80 KB at ns = 10,000
// plus 17 KB of buckets at P = 1,024: two 512-thread blocks per SM; the
// size needs cudaFuncAttributeMaxDynamicSharedMemorySize above 48 KB).
// Both bisections run in one 26-iteration loop: per iteration one block-wide
// count for each array (warp shuffles, then one value per warp through
// double-buffered shared memory, so a single barrier per iteration), and
// every thread takes the same exact integer counts, so all threads walk the
// same thresholds.  Where the terms and the buckets exceed what a block may
// hold (ns above about 26k), the same kernel keeps the terms in an
// [L, 2, ns] scratch that the wrapper allocates; the kernel never allocates.
//
// What bounds it on the card: f32 ALU work in the search, the (point,
// proxy) pairs that the pruning leaves (about 8 flops each) plus the (point,
// box) tests, as in the untrimmed kernels.  The bisection adds about
// 2 * 27 * ns compares per lane, read from shared memory; no [L, ns] term
// tensor ever reaches device memory.
//
// Exactness.  The terms equal the plain version's bit for bit
// (bounds_terms.cuh), the maximum and the counts are exact, and mid is
// rounded as 0.5f * (lo + hi) in float32: the thresholds therefore equal the
// plain version's (fgoicp_tpu_torch/ops/cuda_bounds.py) exactly, and only
// the order of the kept sums differs.  The terms sit at their point's index
// whatever order the search took, so the sums' order does not depend on the
// proxies' buckets or the source order.

#include "bounds_terms.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBisectIters = 26;
// The kept sums run over i = t, t + kSumThreads, ... in threads t <
// kSumThreads, then over the block: a fixed order whatever kThreads is.
constexpr int kSumThreads = 256;

__global__ void __launch_bounds__(kThreads)
bounds_lanes_trimmed_kernel(
    const float* __restrict__ base, const int* __restrict__ gids,
    const float* __restrict__ t, fgoicp::Buckets bk,
    const float* __restrict__ gam_ub, const float* __restrict__ gam_lb,
    const float* __restrict__ gam_t, const float* __restrict__ w, float slack,
    int n_groups, int ns, int n_drop, float* __restrict__ scratch,
    unsigned long long* counts, float* __restrict__ lb_out,
    float* __restrict__ ub_out) {
  extern __shared__ float4 smem[];
  __shared__ float red_f[2][kWarps];
  __shared__ int red_i[2][2][kWarps];

  const int lane = blockIdx.x;
  const size_t g = min(max(gids[lane], 0), n_groups - 1);
  const fgoicp::Node nd{base + g * ns * 3, gam_ub + g * ns, gam_lb + g * ns,
                        t[3 * lane + 0], t[3 * lane + 1], t[3 * lane + 2],
                        gam_t[lane]};
  // The terms: after the search's staged buckets, or in the scratch.
  float* ut_s = scratch != nullptr
                    ? scratch + static_cast<size_t>(lane) * 2 * ns
                    : reinterpret_cast<float*>(
                          reinterpret_cast<char*>(smem) +
                          fgoicp::bucket_smem_bytes(bk.n));
  float* lt_s = ut_s + ns;

  float hi_u = 0.f, hi_l = 0.f;
  fgoicp::for_each_point_pruned<kThreads>(
      nd, w, slack, ns, bk, counts, [&](int i, float ut, float lt) {
        ut_s[i] = ut;
        lt_s[i] = lt;
        hi_u = fmaxf(hi_u, ut);
        hi_l = fmaxf(hi_l, lt);
      });
  // Makes every thread's terms visible (shared or scratch) to the block.
  __syncthreads();
  fgoicp::block_all_reduce2(hi_u, hi_l, red_f[0], red_f[1], fgoicp::Max());

  float lo_u = 0.f, lo_l = 0.f;
  for (int it = 0; it < kBisectIters; ++it) {
    const float mid_u = __fmul_rn(0.5f, __fadd_rn(lo_u, hi_u));
    const float mid_l = __fmul_rn(0.5f, __fadd_rn(lo_l, hi_l));
    int cnt_u = 0, cnt_l = 0;
    for (int i = threadIdx.x; i < ns; i += kThreads) {
      cnt_u += ut_s[i] > mid_u;
      cnt_l += lt_s[i] > mid_l;
    }
    const int buf = it & 1;
    fgoicp::block_all_reduce2(cnt_u, cnt_l, red_i[buf][0], red_i[buf][1],
                              fgoicp::Sum());
    if (cnt_u >= n_drop) lo_u = mid_u; else hi_u = mid_u;
    if (cnt_l >= n_drop) lo_l = mid_l; else hi_l = mid_l;
  }

  // ub: drop sum UNDERestimated (threshold hi); lb: OVERestimated (lo).
  // The kept terms are summed directly (see the header).
  float s_u = 0.f, s_l = 0.f;
  int c_u = 0, c_l = 0;
  for (int i = threadIdx.x; threadIdx.x < kSumThreads && i < ns;
       i += kSumThreads) {
    const float xu = ut_s[i];
    const float xl = lt_s[i];
    if (xu <= hi_u) s_u = __fadd_rn(s_u, xu); else ++c_u;
    if (xl <= lo_l) s_l = __fadd_rn(s_l, xl); else ++c_l;
  }
  const int buf = kBisectIters & 1;  // not the last iteration's buffer
  fgoicp::block_all_reduce2(c_u, c_l, red_i[buf][0], red_i[buf][1],
                            fgoicp::Sum());
  // red_f's maxima were read before the bisection's barriers.
  fgoicp::block_all_reduce2(s_u, s_l, red_f[0], red_f[1], fgoicp::Sum());
  if (threadIdx.x == 0) {
    ub_out[lane] = __fsub_rn(
        s_u, __fmul_rn(static_cast<float>(n_drop - c_u), lo_u));
    lb_out[lane] = __fsub_rn(
        s_l, __fmul_rn(static_cast<float>(n_drop - c_l), lo_l));
  }
}

// Dynamic shared memory a block may use on the current device.
int dynamic_smem_limit(size_t* limit) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr{};
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, bounds_lanes_trimmed_kernel);
  *limit = static_cast<size_t>(optin) - attr.sharedSizeBytes;
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Sets *fits to 1 when a lane's 2 * ns terms fit in shared memory beside the
// staged buckets (no scratch needed), else 0.
int fgoicp_bounds_lanes_trimmed_fits(int ns, int n_buckets, int* fits) {
  size_t limit = 0;
  const int err = dynamic_smem_limit(&limit);
  *fits = fgoicp::bucket_smem_bytes(n_buckets) +
              sizeof(float) * 2 * static_cast<size_t>(ns) <= limit;
  return err;
}

// base [G, ns, 3], gids [L] i32, t [L, 3], rows [n_buckets * 32, 3] and
// boxes [n_buckets, 6] (the bucketed proxies), order [ns] i32 (the source
// order, or null), gam_ub/gam_lb [G, ns], gam_t [L], w [ns] 0/1 (f32 unless
// noted, contiguous, on the device of `stream`); scratch [L, 2, ns] f32 or
// null when the terms fit in shared memory (fgoicp_bounds_lanes_trimmed_fits)
// -> lb_out, ub_out [L] f32.  counts (u64 [2] or null) gets the pairs
// evaluated and the box tests added.
int fgoicp_bounds_lanes_trimmed(const float* base, const int* gids,
                                const float* t, const float* rows,
                                const float* boxes, const int* order,
                                const float* gam_ub, const float* gam_lb,
                                const float* gam_t, const float* w, float slack,
                                int n_groups, int ns, int n_buckets, int lanes,
                                int n_drop, float* scratch,
                                unsigned long long* counts, float* lb_out,
                                float* ub_out, cudaStream_t stream) {
  if (lanes <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem =
      fgoicp::bucket_smem_bytes(n_buckets) +
      (scratch != nullptr ? 0 : sizeof(float) * 2 * static_cast<size_t>(ns));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bounds_lanes_trimmed_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const fgoicp::Buckets bk{rows, boxes, order, n_buckets};
  bounds_lanes_trimmed_kernel<<<lanes, kThreads, smem, stream>>>(
      base, gids, t, bk, gam_ub, gam_lb, gam_t, w, slack, n_groups, ns,
      n_drop, scratch, counts, lb_out, ub_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
