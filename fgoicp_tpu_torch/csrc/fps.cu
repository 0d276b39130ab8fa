// Farthest-point sampling in one launch for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's FPS
// (fgoicp_tpu/ops/coreset.py::farthest_point_sample) is a lax.fori_loop of
// XLA ops, not a pallas_call.  Its port, the plain torch loop
// (fgoicp_tpu_torch/ops/cuda_fps.py::farthest_point_sample_plain), issues
// about 11 small launches a step from the host, so on the card the host's
// issue time paces it (1,023 steps a call).  This kernel walks all k - 1
// steps on the device, in one launch.
//
// What it computes, bit for bit as the plain loop: idx[0] = start; a running
// minimum m_i of the squared distance from point i to the points picked so
// far, updated after each pick c as m_i = min(m_i, d2(p_i, c)) with
//     d = p - c per axis, d2 = (dx*dx + dy*dy) + dz*dz
// (__fsub_rn / __fmul_rn / __fadd_rn, the library built with --fmad=false:
// every operation rounded on its own, in _sq_dist_to's order; min exact);
// idx[s] = the first index among the maxima of m.  m starts at +inf, and
// min(+inf, d2) = d2, so the first update gives the loop's initial minima.
// Once every point is picked all minima are 0, and index 0 repeats (k > n),
// as torch.argmax does.
//
// What bounds it.  Each step is a reduction over all points that the next
// step depends on, so one block walks them all, on one SM: a step costs the
// point updates at that SM's issue rate (about 17 instructions a point with
// the loads, the store and the compare: 1.2 us for 18,000 points at 128
// thread-instructions a clock, 1.98 GHz) plus the latency of one block
// barrier and two warp reductions (a few hundred clocks), which sets the
// pace below a few thousand points.  The flops (9 a point) are nothing.
//
// Design.  One block of kThreads = 1,024 threads; thread t owns the points
// i = t (mod 1,024).  A step: each thread updates its points' minima with
// the last pick's distance and keeps its best (value, first index); a warp
// reduction of the 64-bit keys (bits(m) << 32) | (0xFFFFFFFF - i) by
// __shfl_xor_sync; lane 0 of each warp writes its key to a shared buffer;
// one __syncthreads; every warp reduces the 32 keys itself, so every thread
// knows the pick without a second barrier.  m >= +0 (never -0, a sum of
// squares), and for such floats the bit pattern orders as the value, so the
// largest key is the largest minimum and, among equal ones, the smallest
// index.  The key buffer alternates between two halves by step parity: a
// warp writes step s + 1's half only after step s's barrier, which every
// reader of step s - 1's keys (the same half) has passed.
// Memory by size (the layout, chosen from n by ops/cuda_fps.py::plan_layout,
// which also owns the shared-memory limit and passes it in):
//   kShared: coordinates (SoA) and minima in dynamic shared memory, 16 B a
//            point (up to 14,496 points on an H100);
//   kMinima: coordinates read from global memory each step (the [n, 3]
//            input stays in L2), minima in shared memory, 4 B a point (up
//            to 57,984);
//   kGlobal: coordinates and minima (a [n] scratch the wrapper allocates) in
//            global memory.
// kShared beats kMinima by 6-14 % a call at 3,037-14,496 points on an H100
// (the coordinates' shared-memory reads against L2's); kMinima beats
// kGlobal by 4-9 %.  The dynamic shared-memory limit of a layout's kernel is
// raised once per device, to the limit the wrapper passes.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <atomic>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;

enum Layout { kShared = 0, kMinima = 1, kGlobal = 2 };

__device__ __forceinline__ float sq_dist(float px, float py, float pz,
                                         float cx, float cy, float cz) {
  const float dx = __fsub_rn(px, cx);
  const float dy = __fsub_rn(py, cy);
  const float dz = __fsub_rn(pz, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  return v;
}

// points [n, 3] f32; idx_out [k] int64; scratch [n] f32 (kGlobal only).
template <int kLayout>
__global__ void __launch_bounds__(kThreads, 1)
fps_kernel(const float* __restrict__ points, int n, int k, int start,
           float* __restrict__ scratch, long long* __restrict__ idx_out) {
  extern __shared__ float smem[];
  __shared__ unsigned long long keys[2][kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float* sx = smem;
  float* sy = smem + n;
  float* sz = smem + 2 * static_cast<long long>(n);
  float* mind = kLayout == kShared ? smem + 3 * static_cast<long long>(n)
              : kLayout == kMinima ? smem
                                   : scratch;
  for (int i = tid; i < n; i += kThreads) {
    if (kLayout == kShared) {
      const long long o = 3LL * i;
      sx[i] = points[o];
      sy[i] = points[o + 1];
      sz[i] = points[o + 2];
    }
    mind[i] = CUDART_INF_F;
  }
  if (tid == 0) idx_out[0] = start;
  __syncthreads();  // the staged coordinates, read by every thread below

  int c = start;
  for (int s = 1; s < k; ++s) {
    float cx, cy, cz;
    if (kLayout == kShared) {
      cx = sx[c];
      cy = sy[c];
      cz = sz[c];
    } else {
      const long long o = 3LL * c;
      cx = points[o];
      cy = points[o + 1];
      cz = points[o + 2];
    }
    float best = -1.f;  // below every minimum: a thread with points wins
    int best_i = 0;
    for (int i = tid; i < n; i += kThreads) {
      float px, py, pz;
      if (kLayout == kShared) {
        px = sx[i];
        py = sy[i];
        pz = sz[i];
      } else {
        const long long o = 3LL * i;
        px = points[o];
        py = points[o + 1];
        pz = points[o + 2];
      }
      const float m = fminf(mind[i], sq_dist(px, py, pz, cx, cy, cz));
      mind[i] = m;
      if (m > best) {  // strict: the first of equal maxima (i increases)
        best = m;
        best_i = i;
      }
    }
    // A thread without points contributes 0, below every point's key (its
    // low word 0xFFFFFFFF - i is at least 2^31).
    unsigned long long key =
        best < 0.f ? 0ull
                   : (static_cast<unsigned long long>(__float_as_uint(best))
                      << 32) |
                         (0xFFFFFFFFu - static_cast<unsigned>(best_i));
    key = warp_max(key);
    if (lane == 0) keys[s & 1][warp] = key;
    __syncthreads();
    key = warp_max(keys[s & 1][lane]);
    c = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(key));
    if (tid == 0) idx_out[s] = c;
  }
}

// Bytes of dynamic shared memory a point takes in each layout (the carve-up
// above; ops/cuda_fps.py::LAYOUTS plans with the same numbers).
size_t smem_bytes(int layout, int n) {
  const size_t per_point = layout == kShared ? 16 : layout == kMinima ? 4 : 0;
  return per_point * static_cast<size_t>(n);
}

// Raise the dynamic shared-memory limit of the layout's kernel to `limit`,
// once per device (again only for a larger limit; a repeat by a racing
// thread is harmless).
cudaError_t configure(int layout, int limit) {
  static std::atomic<int> set_to[kMaxDevices][2];
  if (layout == kGlobal) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && set_to[dev][layout].load() >= limit)
    return cudaSuccess;
  err = layout == kShared
            ? cudaFuncSetAttribute(fps_kernel<kShared>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   limit)
            : cudaFuncSetAttribute(fps_kernel<kMinima>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   limit);
  if (err == cudaSuccess && dev < kMaxDevices) set_to[dev][layout].store(limit);
  return err;
}

}  // namespace

extern "C" {

// points [n, 3] f32 contiguous -> idx_out [k] int64, on the device of
// `stream`: 1 <= n < 2^31, k >= 1, 0 <= start < n; layout 0, 1 or 2 (the
// wrapper's plan for n) and smem_limit, the dynamic shared memory a block
// may take (the wrapper's); scratch [n] f32 for layout 2, else null.
int fgoicp_fps(const float* points, int n, int k, int start, int layout,
               int smem_limit, float* scratch, long long* idx_out,
               cudaStream_t stream) {
  const size_t smem = smem_bytes(layout, n);
  if (n <= 0 || k <= 0 || start < 0 || start >= n || layout < kShared ||
      layout > kGlobal || smem_limit < 0 ||
      smem > static_cast<size_t>(smem_limit) ||
      (layout == kGlobal && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = configure(layout, smem_limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (layout) {
    case kShared:
      fps_kernel<kShared><<<1, kThreads, smem, stream>>>(points, n, k, start,
                                                         scratch, idx_out);
      break;
    case kMinima:
      fps_kernel<kMinima><<<1, kThreads, smem, stream>>>(points, n, k, start,
                                                         scratch, idx_out);
      break;
    default:
      fps_kernel<kGlobal><<<1, kThreads, 0, stream>>>(points, n, k, start,
                                                      scratch, idx_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
