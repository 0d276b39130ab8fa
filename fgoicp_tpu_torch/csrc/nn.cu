// Exact nearest neighbour (min + argmin, and min only) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels fgoicp_tpu/ops/pallas_nn.py::nn_argmin
// (_kernel) and ::nn_min (_kernel_min).  For every query q and target points
// c_j it computes
//     d2 = (c_x - q_x)^2 + (c_y - q_y)^2 + (c_z - q_z)^2      (direct differences)
// and keeps the minimum over j, starting from BIG = 1e10 with a strict `<`,
// and (nn_argmin) the first index j among equal minima, clamped to T - 1;
// (BIG, 0) where no target beats BIG.  That is the Pallas kernel's rule
// (first index inside a target tile, strict `<` across tiles).
//
// What bounds it.  Issued instructions, not bytes or the f32 peak: with
// --fmad=false every subtraction, product, sum and min issues on its own,
// and the card issues one warp instruction per clock on each of its 4 x 132
// schedulers (3.35e13 thread-instructions/s at 1.98 GHz).  Per
// (query, target) pair nn_min issues 3 sub + 3 mul + 2 add + 1 min = 9, plus
// a quarter of a shared load; nn_argmin about 9.75 (below).  Memory traffic
// is small: the targets (12 B each, 216 KB at 18,000) stay in L2 and are
// staged once per block; each query is read once and written once.  wgmma
// and TMA do not apply: distances stay off the tensor cores, because the
// norm expansion ||q||^2 + ||c||^2 - 2 q.c cancels catastrophically near zero
// and would change argmins (the exact-distance rule of ROADMAP.md).
//
// Design.
// 1. Register tiling: each thread holds kQ = 4 queries (coordinates, running
//    minimum, index), so one 16-byte broadcast load of a target staged in
//    shared memory as float4 (x, y, z, 0) feeds 4 distances.
// 2. Argmin by groups of 4 targets: the inner loop takes the min of the 4
//    distances of a group (3 fmin) and compares it with the running minimum
//    (1 compare, 2 selects: value and group), 9.5 issues a pair instead of
//    11 for a compare and two selects per pair.  After each staged tile, a
//    query whose minimum fell in it recomputes, from shared memory, the
//    distances of its winning group and takes the first index whose distance
//    equals the minimum; the arithmetic is the same, so the values are
//    bit-equal.  Groups are visited in increasing index with a strict `<`,
//    so the earliest group holding the minimum wins, and inside it the first
//    equal index: the global first index of the minimum.  A tile whose length
//    is not a multiple of 4 is padded in shared memory with (inf, inf, inf),
//    whose distance never beats anything (and fmin ignores NaN, as a strict
//    `<` does).
// 3. Target splits: a 2-D grid, blockIdx.x the tile of kThreads x kQ = 512
//    queries, blockIdx.y a contiguous slice [y * chunk, (y + 1) * chunk) of
//    the targets.  The planner (ops/cuda_nn.py::plan_splits) picks the slice
//    count from M, T and the card's SM count so that a small query grid (the
//    3,000-query polish: 6 tiles) still fills every SM; with one slice the
//    kernel writes d2 / idx directly, in one launch.
// 4. The merge across slices is exact and deterministic:
//    - nn_argmin: each block's partial (d2, j) with d2 < BIG goes into a [M]
//      64-bit buffer by atomicMin on the key (float_as_uint(d2) << 32) | j,
//      the buffer first filled with the key of (BIG, 0).  d2 is a sum of
//      squares: +0 or positive (never -0; a NaN never becomes a partial), and
//      for such floats the bit pattern orders as the value.  So the 64-bit
//      minimum is the smallest d2 and, among equal d2, the smallest j: the
//      global first index of the minimum, whatever the order of the atomics.
//      A d2 >= BIG is never a partial, and nothing is below BIG's key only if
//      no target beats BIG: the strict `<` from BIG.  The last block of each
//      query tile to finish (a counter per tile, zeroed with the fill;
//      __threadfence before and after it) unpacks the tile's keys into d2 [M]
//      f32 and idx [M] i32: two launches, the fill and the search.
//    - nn_min: atomicMin on the 32-bit pattern of d2 in d2_out itself, first
//      filled with BIG; the same order argument, nothing to unpack.
// 5. 64-bit offsets for every 3 * index: M may reach 2^31 - 1.
//
// Rounding.  The distance is written with __fsub_rn/__fmul_rn/__fadd_rn and
// the library is built with --fmad=false, so every difference, product and
// sum is rounded on its own, in the order of the plain PyTorch version
// (fgoicp_tpu_torch/ops/cuda_nn.py); min and compare are exact.  d2 and idx
// agree with it bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;
constexpr int kQ = 4;                          // queries held by one thread
constexpr int kQueryTile = kThreads * kQ;      // queries per block (x)
constexpr int kGroup = 4;                      // targets per argmin group
constexpr int kTile = 1024;                    // targets staged per pass
constexpr float kBig = 1e10f;
constexpr int kMaxSplits = 65535;              // gridDim.y limit
constexpr int kElemThreads = 256;              // the fill kernel's blocks

static_assert(kTile % kGroup == 0, "a tile holds whole groups");

__device__ __forceinline__ float sq_dist(float cx, float cy, float cz,
                                         float qx, float qy, float qz) {
  const float dx = __fsub_rn(cx, qx);
  const float dy = __fsub_rn(cy, qy);
  const float dz = __fsub_rn(cz, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// The first u in [0, kGroup) whose distance from q is d2, the minimum of the
// group's distances (the last one when none of the others is: one is).
__device__ __forceinline__ int first_equal(const float4* c, float qx,
                                           float qy, float qz, float d2) {
  int u = kGroup - 1;
#pragma unroll
  for (int v = kGroup - 2; v >= 0; --v)
    if (sq_dist(c[v].x, c[v].y, c[v].z, qx, qy, qz) == d2) u = v;
  return u;
}

// One block: kQueryTile queries (blockIdx.x) against the target slice
// blockIdx.y.  kMerge: several slices, merged by atomicMin (keys for the
// argmin, d2_out's bits for the min); else the outputs are written directly.
// keys: [m] merge keys, then [gridDim.x] counters of finished slices.
template <bool kWantIdx, bool kMerge>
__global__ void __launch_bounds__(kThreads)
nn_kernel(const float* __restrict__ queries, const float* __restrict__ points,
          int m, int t, int chunk, float* __restrict__ d2_out,
          int* __restrict__ idx_out, unsigned long long* __restrict__ keys) {
  __shared__ float4 tile[kTile];
  __shared__ bool last_slice;

  const int lo = blockIdx.y * chunk;           // < t by the plan's check
  const int hi = lo + min(chunk, t - lo);
  const long long first =
      static_cast<long long>(blockIdx.x) * kQueryTile + threadIdx.x;

  float qx[kQ], qy[kQ], qz[kQ], best[kQ];
  int idx[kQ];
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const long long i = first + k * kThreads;
    const bool live = i < m;
    qx[k] = live ? queries[3 * i + 0] : 0.f;
    qy[k] = live ? queries[3 * i + 1] : 0.f;
    qz[k] = live ? queries[3 * i + 2] : 0.f;
    best[k] = kBig;
    idx[k] = 0;
  }

  for (int base = lo; base < hi; base += kTile) {
    const int n = min(kTile, hi - base);
    const int n_pad = (n + kGroup - 1) / kGroup * kGroup;
    for (int j = threadIdx.x; j < n_pad; j += kThreads) {
      if (j < n) {
        const long long o = 3LL * (base + j);
        tile[j] = make_float4(points[o], points[o + 1], points[o + 2], 0.f);
      } else {
        tile[j] = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, 0.f);
      }
    }
    __syncthreads();
    int won[kQ];  // the tile's group that last lowered the minimum, or -1
#pragma unroll
    for (int k = 0; k < kQ; ++k) won[k] = -1;
#pragma unroll 2
    for (int j = 0; j < n_pad; j += kGroup) {
      float4 c[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) c[u] = tile[j + u];
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        float g = sq_dist(c[0].x, c[0].y, c[0].z, qx[k], qy[k], qz[k]);
#pragma unroll
        for (int u = 1; u < kGroup; ++u)
          g = fminf(g, sq_dist(c[u].x, c[u].y, c[u].z, qx[k], qy[k], qz[k]));
        if (kWantIdx) {
          if (g < best[k]) {
            best[k] = g;
            won[k] = j;
          }
        } else {
          best[k] = fminf(best[k], g);
        }
      }
    }
    if (kWantIdx) {
#pragma unroll
      for (int k = 0; k < kQ; ++k)
        if (won[k] >= 0)
          idx[k] = base + won[k] +
                   first_equal(tile + won[k], qx[k], qy[k], qz[k], best[k]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const long long i = first + k * kThreads;
    if (i >= m) continue;
    if (!kMerge) {
      d2_out[i] = best[k];
      if (kWantIdx) idx_out[i] = min(idx[k], t - 1);
    } else if (best[k] < kBig) {
      if (kWantIdx) {
        atomicMin(keys + i,
                  (static_cast<unsigned long long>(__float_as_uint(best[k]))
                   << 32) | static_cast<unsigned int>(idx[k]));
      } else {
        atomicMin(reinterpret_cast<unsigned int*>(d2_out) + i,
                  __float_as_uint(best[k]));
      }
    }
  }

  if (kWantIdx && kMerge) {
    // The last slice of this query tile to finish unpacks the tile's keys.
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last_slice = atomicAdd(keys + m + blockIdx.x, 1ull) == gridDim.y - 1;
    __syncthreads();
    if (!last_slice) return;
    __threadfence();
#pragma unroll
    for (int k = 0; k < kQ; ++k) {
      const long long i = first + k * kThreads;
      if (i >= m) continue;
      const unsigned long long key = __ldcg(keys + i);  // from L2
      d2_out[i] = __uint_as_float(static_cast<unsigned int>(key >> 32));
      idx_out[i] = min(static_cast<int>(key & 0xffffffffu), t - 1);
    }
  }
}

// Before a merge: keys = the key of (BIG, 0) and the tiles' counters 0, or
// d2_out = BIG.
template <bool kWantIdx>
__global__ void fill_big_kernel(float* __restrict__ d2_out,
                                unsigned long long* __restrict__ keys, int m,
                                int tiles) {
  const long long n = kWantIdx ? static_cast<long long>(m) + tiles : m;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (kWantIdx) {
      keys[i] = i < m ? static_cast<unsigned long long>(__float_as_uint(kBig))
                            << 32
                      : 0ull;
    } else {
      d2_out[i] = kBig;
    }
  }
}

// The plan must cut [0, t) into `splits` non-empty slices of `chunk`.
bool plan_ok(int t, int splits, int chunk) {
  return splits >= 1 && splits <= kMaxSplits && chunk >= 1 &&
         static_cast<long long>(splits - 1) * chunk < t &&
         static_cast<long long>(splits) * chunk >= t;
}

template <bool kWantIdx>
int launch(const float* queries, const float* points, int m, int t,
           int splits, int chunk, float* d2_out, int* idx_out,
           unsigned long long* keys, cudaStream_t stream) {
  if (t < 1 || !plan_ok(t, splits, chunk) ||
      (kWantIdx && splits > 1 && keys == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  const int tiles = (m - 1) / kQueryTile + 1;  // m + 511 could overflow
  const dim3 grid(tiles, splits);
  if (splits == 1) {
    nn_kernel<kWantIdx, false><<<grid, kThreads, 0, stream>>>(
        queries, points, m, t, chunk, d2_out, idx_out, keys);
    return static_cast<int>(cudaGetLastError());
  }
  const int fill_blocks = std::min((m - 1) / kElemThreads + 1, 4096);
  fill_big_kernel<kWantIdx><<<fill_blocks, kElemThreads, 0, stream>>>(
      d2_out, keys, m, tiles);
  nn_kernel<kWantIdx, true><<<grid, kThreads, 0, stream>>>(
      queries, points, m, t, chunk, d2_out, idx_out, keys);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// queries [m, 3], points [t, 3] f32, contiguous, on the device of `stream`;
// the targets cut into `splits` slices of `chunk` (the last one shorter).
// d2_out [m] f32, idx_out [m] i32; keys: a u64 workspace of
// m + ceil(m / 512) elements (merge keys, then one counter per query tile),
// used (and needed) only when splits > 1.
int fgoicp_nn_argmin(const float* queries, const float* points, int m, int t,
                     int splits, int chunk, float* d2_out, int* idx_out,
                     unsigned long long* keys, cudaStream_t stream) {
  return launch<true>(queries, points, m, t, splits, chunk, d2_out, idx_out,
                      keys, stream);
}

int fgoicp_nn_min(const float* queries, const float* points, int m, int t,
                  int splits, int chunk, float* d2_out, cudaStream_t stream) {
  return launch<false>(queries, points, m, t, splits, chunk, d2_out, nullptr,
                       nullptr, stream);
}

const char* fgoicp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
