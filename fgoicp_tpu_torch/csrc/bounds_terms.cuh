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
// The search for m: one block per node, an exact box-pruned search
// (for_each_point_pruned), shared by all three kernels.
// ops/cuda_bounds.py::proxy_buckets orders the proxies by a Morton code
// refined by median splits (a kd-tree's leaves) and cuts them into buckets of
// kBucket with the exact min / max box of each bucket's members (the ragged
// last bucket padded with copies of its own members, which cannot change a
// minimum); cuda_bounds.source_order orders the source points the same way in
// runs of 32 * kPrunedPerThread.  Each warp owns one such run, a compact patch
// of the source (with no order, the points as they come).  Pass 1 evaluates
// one member of every bucket, so every point holds a running minimum m that
// is a real distance.  Pass 2 visits the buckets: each point computes the
// lower bound box_d2 of its distance to the bucket's box, and the warp skips
// the bucket when box_d2 >= m for all of its points; otherwise it scans the
// bucket's members.  What bounds it: the pairs
// evaluated (kBucket per scanned bucket and one per bucket in pass 1) plus
// one box test per (point, bucket), about 19 issued instructions each; the
// work depends on the data.  Two points a thread halve the patch a warp
// owns, so fewer buckets are scanned for it.  The untrimmed kernels sum the
// terms (node_bounds); the trimmed one stores them for its bisection.
//
// Why the pruned search is exact.  box_d2 takes gap = fmax(lo - q, q - hi, 0)
// per axis and then (gx*gx + gy*gy) + gz*gz, with the same _rn operations in
// the same order as sq_dist.  For every member p of the box and q < lo on an
// axis, p - q >= lo - q > 0 in exact arithmetic; round-to-nearest is monotone,
// so fl(p - q) >= fl(lo - q) >= 0, and the same holds on the other side by
// sign symmetry (fl(q - p) = -fl(p - q)) and trivially (gap 0) inside.
// Squares of non-negative values, and sums, keep the order when rounded, so
// box_d2(q) <= sq_dist(p, q) as computed, for every member.  A skipped bucket
// thus holds no value below the point's current m (itself above the final
// minimum), and fminf over the pairs evaluated gives the same bits as the
// full scan: a minimum does not depend on the order of its operands, so
// sorting the proxies changes nothing either.
//
// wgmma and TMA do not apply: distances stay off the tensor cores under the
// exact-distance rule of ROADMAP.md (the bounds must stay valid,
// lb <= SSE <= ub, and the norm-expansion form cancels near zero).
//
// Rounding.  __fmul_rn/__fadd_rn/__fsub_rn in the order of the plain PyTorch
// versions (fgoicp_tpu_torch/ops/cuda_bounds.py), the library built with
// --fmad=false, IEEE sqrtf: every term equals the plain version's bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace fgoicp {

constexpr float kBig = 1e10f;
constexpr int kBucket = 32;    // proxies per bucket (cuda_bounds.BUCKET)
// Source points per thread per pass of the pruned search: a warp owns
// 32 * kPrunedPerThread consecutive entries of the order
// (cuda_bounds.WARP_POINTS).
constexpr int kPrunedPerThread = 2;
constexpr int kTileBuckets = 64;  // buckets staged at once (34 KB of float4)
constexpr int kRep = kBucket / 2;  // the member evaluated in pass 1

__device__ __forceinline__ float sq_dist(const float4 c, float qx, float qy,
                                         float qz) {
  const float dx = __fsub_rn(c.x, qx);
  const float dy = __fsub_rn(c.y, qy);
  const float dz = __fsub_rn(c.z, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// A lower bound of sq_dist(p, q) as computed, for every p in the box
// [lo, hi] (see "Why the pruned search is exact" above).
__device__ __forceinline__ float box_d2(const float4 lo, const float4 hi,
                                        float qx, float qy, float qz) {
  const float gx = fmaxf(fmaxf(__fsub_rn(lo.x, qx), __fsub_rn(qx, hi.x)), 0.f);
  const float gy = fmaxf(fmaxf(__fsub_rn(lo.y, qy), __fsub_rn(qy, hi.y)), 0.f);
  const float gz = fmaxf(fmaxf(__fsub_rn(lo.z, qz), __fsub_rn(qz, hi.z)), 0.f);
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                   __fmul_rn(gz, gz));
}

// Rows [p0, p0 + n) of a [*, 3] array into shared memory as float4.
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

// ut_i and lt_i of point i from its nearest-proxy value m.
__device__ __forceinline__ void point_terms(const Node& nd,
                                            const float* __restrict__ w,
                                            float slack, int i, float m,
                                            float& ut, float& lt) {
  const float d = sqrtf(fmaxf(m, 0.f));
  const float wi = w[i];
  const float u = fmaxf(__fsub_rn(d, nd.gam_ub[i]), 0.f);
  const float v = fmaxf(
      __fsub_rn(__fsub_rn(__fsub_rn(d, slack), nd.gam_lb[i]), nd.gt), 0.f);
  ut = __fmul_rn(wi, __fmul_rn(u, u));
  lt = __fmul_rn(wi, __fmul_rn(v, v));
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

// The bucketed proxies and the source order of the pruned search
// (ops/cuda_bounds.py::proxy_buckets, source_order): rows [n * kBucket, 3] in
// Morton order, boxes [n, 6] (lo xyz, hi xyz of each bucket's members), order
// [ns] a permutation of the source points or null (the identity).
struct Buckets {
  const float* rows;
  const float* boxes;
  const int* order;
  int n;
};

// Dynamic shared memory of node_bounds: the proxies and box corners of up to
// kTileBuckets buckets, as float4.
__host__ __device__ inline size_t bucket_smem_bytes(int n_buckets) {
  const int tile = n_buckets < kTileBuckets ? n_buckets : kTileBuckets;
  return static_cast<size_t>(tile) * (kBucket + 2) * sizeof(float4);
}

// Buckets [b0, b0 + n) into shared memory: members into sp, box corners
// (lo, hi) into sb.
__device__ __forceinline__ void stage_buckets(const Buckets& bk, int b0,
                                              int n, float4* sp, float4* sb) {
  stage_proxies(bk.rows, b0 * kBucket, n * kBucket, sp);
  stage_proxies(bk.boxes, 2 * b0, 2 * n, sb);
}

// Calls f(i, ut_i, lt_i) once for every source point i of one node, on the
// thread that owns it, by the box-pruned search; each thread calls f in the
// order of its points in the source order.  Every thread of the block
// (kThreads) must call it, with bucket_smem_bytes(bk.n) of dynamic shared
// memory from offset 0; it synchronises the block.  When counts is not
// null, counts[0] gets the (point, proxy) pairs evaluated and counts[1] the
// (point, box) tests, over the valid points.
template <int kThreads, typename F>
__device__ __forceinline__ void for_each_point_pruned(
    const Node& nd, const float* __restrict__ w, float slack, int ns,
    const Buckets& bk, unsigned long long* counts, F f) {
  constexpr int kP = kPrunedPerThread;
  extern __shared__ float4 smem[];
  const int tile = min(bk.n, kTileBuckets);
  float4* sp = smem;                   // tile * kBucket members
  float4* sb = smem + tile * kBucket;  // 2 * tile box corners
  const bool staged = bk.n <= kTileBuckets;
  if (staged) {
    stage_buckets(bk, 0, bk.n, sp, sb);
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned long long pairs = 0, tests = 0;
  for (int i0 = 0; i0 < ns; i0 += kThreads * kP) {
    int idx[kP];
    bool valid[kP];
    float qx[kP], qy[kP], qz[kP], m[kP];
    int n_valid = 0;
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      // The warp's run: 32 * kP consecutive entries of the source order.
      const int pos = i0 + (warp * kP + k) * 32 + lane;
      valid[k] = pos < ns;
      idx[k] = !valid[k] ? 0 : bk.order != nullptr ? bk.order[pos] : pos;
      const float* b = nd.base + 3 * static_cast<size_t>(idx[k]);
      qx[k] = __fadd_rn(b[0], nd.tx);
      qy[k] = __fadd_rn(b[1], nd.ty);
      qz[k] = __fadd_rn(b[2], nd.tz);
      m[k] = kBig;
      n_valid += __popc(__ballot_sync(0xffffffffu, valid[k]));
    }
    // Pass 1: one member of every bucket.
    for (int b = 0; b < bk.n; ++b) {
      float4 c;
      if (staged) {
        c = sp[b * kBucket + kRep];
      } else {
        const float* r =
            bk.rows + 3 * (static_cast<size_t>(b) * kBucket + kRep);
        c = make_float4(__ldg(r), __ldg(r + 1), __ldg(r + 2), 0.f);
      }
#pragma unroll
      for (int k = 0; k < kP; ++k) {
        m[k] = fminf(m[k], sq_dist(c, qx[k], qy[k], qz[k]));
      }
    }
    // Pass 2: the buckets whose box may hold a value below m.
    int scanned = 0;
    for (int b0 = 0; b0 < bk.n; b0 += kTileBuckets) {
      const int nb = min(kTileBuckets, bk.n - b0);
      if (!staged) {
        __syncthreads();
        stage_buckets(bk, b0, nb, sp, sb);
        __syncthreads();
      }
      for (int b = 0; b < nb; ++b) {
        const float4 lo = sb[2 * b];
        const float4 hi = sb[2 * b + 1];
        bool need = false;
#pragma unroll
        for (int k = 0; k < kP; ++k) {
          need |= valid[k] && box_d2(lo, hi, qx[k], qy[k], qz[k]) < m[k];
        }
        if (!__any_sync(0xffffffffu, need)) continue;
        ++scanned;
        const float4* c = sp + b * kBucket;
#pragma unroll 8
        for (int j = 0; j < kBucket; ++j) {
          const float4 cj = c[j];
#pragma unroll
          for (int k = 0; k < kP; ++k) {
            m[k] = fminf(m[k], sq_dist(cj, qx[k], qy[k], qz[k]));
          }
        }
      }
    }
    pairs += static_cast<unsigned long long>(n_valid) *
             (bk.n + scanned * kBucket);
    tests += static_cast<unsigned long long>(n_valid) * bk.n;
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      if (valid[k]) {
        float ut, lt;
        point_terms(nd, w, slack, idx[k], m[k], ut, lt);
        f(idx[k], ut, lt);
      }
    }
  }
  if (counts != nullptr && lane == 0) {
    atomicAdd(counts, pairs);
    atomicAdd(counts + 1, tests);
  }
}

// lb, ub of one node: the weighted term sums over all source points, each
// thread's in its points' source order, then over the block.  Used by the
// untrimmed lane and grid kernels; arguments as for_each_point_pruned.
template <int kThreads>
__device__ __forceinline__ void node_bounds(
    const Node& nd, const float* __restrict__ w, float slack, int ns,
    const Buckets& bk, float* lb_out, float* ub_out,
    unsigned long long* counts) {
  __shared__ float red_lb[kThreads / 32];
  __shared__ float red_ub[kThreads / 32];
  float acc_lb = 0.f;
  float acc_ub = 0.f;
  for_each_point_pruned<kThreads>(nd, w, slack, ns, bk, counts,
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
