// The lockstep ICP iteration's non-NN work in two launches, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package's ICP step
// (fgoicp_tpu/models/icp.py, fgoicp_tpu/ops/procrustes.py) is XLA ops inside
// a lax.while_loop, not a pallas_call.  Its port's plain version
// (fgoicp_tpu_torch/ops/cuda_icp.py::icp_align_plain / icp_commit_plain,
// the body of models/icp.py::icp_batched's loop) issues about 160 small ops
// an iteration from the host (9 determinant-scaled Newton steps, each a
// batched det and inverse of [G, 3, 3]; an eigh; the gather, centroids,
// einsums and masked selects), so on the card the host paces the loop.  An
// iteration here is icp_align, the NN kernel (csrc/nn.cu, unchanged) and
// icp_commit: three launches and one host read of `running`.
//
// icp_align, one block a lane g that is not done (done lanes return at once;
// block 0 first zeroes `running`, which icp_commit then counts):
//   1. the lane's weighted sums over its ns points: sum w, sum w s and
//      sum w c, c = target[idx] the correspondences (w = 1 without weights);
//      the centroids mu_s, mu_c = sums / max(sum w, 1e-12);
//   2. a second pass for the centred cross-covariance
//      ABt[r][c] = sum_i (s_i - mu_s)[r] w_i (c_i - mu_c)[c]
//      (procrustes's formula, b unweighted);
//   3. thread 0 runs closest_rotation's recurrence on M = ABt^T in
//      registers: x = M / max(||M||_F, 1e-30); the rank guard's ridge
//      x += 1e-3 I where |det x| < 1e-6; 9 Newton steps
//      x <- (z x + (z x)^-T) / 2, z = clamp(|det x|, 1e-12)^(-1/3) clamped
//      to [1e-3, 1e6], (z x)^-T the cofactor matrix over the determinant;
//      where det(Q) < 0 of the result Q, the reflection fix
//      Q <- Q (I - 2 v v^T), v the unit eigenvector of the smallest
//      eigenvalue of M^T M by cyclic Jacobi (computed only then);
//      t_ = mu_c - Q mu_s; then last_R = R, last_t = t, R = Q R,
//      t = Q t + t_;
//   4. every thread moves its points in place: s <- Q s + t_.
// A running lane always takes the new points and a done lane is not
// touched, so the NN launch that follows writes d2 and idx directly: a done
// lane's queries are unchanged and return the same bits.
//
// icp_commit, one block a lane that is not done: sse_new = sum_i w_i d2_i
// (sum d2_i without weights); last_sse = sse, sse = sse_new; the reference's
// loop guard (icp3d.cu:94) marks the lane done when
// last_sse - sse <= threshold * last_sse; a lane still running adds 1 to
// `running`, the one int the host reads.
//
// What bounds it.  Bytes (ops/cuda_icp.py::traffic): 40 B a point in
// icp_align (cur read and written, idx, the gathered target point), 4 B in
// icp_commit (d2), and 4 B more in each with weights; the passes' rereads
// of a lane's points hit L1 / L2.  At the serving seeding shape (480 lanes
// x 2,048 points) that is ~39 MB, 12 us at 3.35 TB/s; below it the
// launch latency and thread 0's 3x3 recurrence (a few hundred dependent
// float ops, a few us) set the time, overlapped across lanes when several
// blocks share an SM.
//
// Rounding.  float32 throughout, the library built with --fmad=false (each
// product and sum rounded on its own).  The sums run in another order than
// torch.sum's and the plain path's einsums, so R and t agree with the plain
// version within rounding (a few ulp of the sums, ~1e-6 relative), not bit
// for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kNewtonSteps = 9;
constexpr int kJacobiSweeps = 10;

// The N sums of every thread's v, in a fixed order (warp shuffles, then
// warp 0 over the warps' partials); every thread returns with the totals.
// `part` holds kMaxWarps x N partials, `out` N totals.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* part,
                                          float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[k] += __shfl_down_sync(0xffffffffu, v[k], o);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < N; ++k) part[warp * N + k] = v[k];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float s = lane < warps ? part[lane * N + k] : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, o);
      if (lane == 0) out[k] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = out[k];
}

// The cofactor matrix C of row-major a (C[i][j] = (-1)^(i+j) minor_ij) and
// det a = a[0] C[0] + a[1] C[1] + a[2] C[2]; a^-T = C / det a.
__device__ __forceinline__ float cofactors(const float* a, float* c) {
  c[0] = a[4] * a[8] - a[5] * a[7];
  c[1] = a[5] * a[6] - a[3] * a[8];
  c[2] = a[3] * a[7] - a[4] * a[6];
  c[3] = a[2] * a[7] - a[1] * a[8];
  c[4] = a[0] * a[8] - a[2] * a[6];
  c[5] = a[1] * a[6] - a[0] * a[7];
  c[6] = a[1] * a[5] - a[2] * a[4];
  c[7] = a[2] * a[3] - a[0] * a[5];
  c[8] = a[0] * a[4] - a[1] * a[3];
  return (a[0] * c[0] + a[1] * c[1]) + a[2] * c[2];
}

__device__ __forceinline__ float det3(const float* a) {
  float c[9];
  return cofactors(a, c);
}

// Unit eigenvector of the smallest eigenvalue of the symmetric s (row-major;
// destroyed), by cyclic Jacobi rotations (Numerical Recipes' update).
__device__ void smallest_eigvec(float* s, float* v_out) {
  float v[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
  const int pairs[3][2] = {{0, 1}, {0, 2}, {1, 2}};
  for (int sweep = 0; sweep < kJacobiSweeps; ++sweep) {
    for (int k = 0; k < 3; ++k) {
      const int p = pairs[k][0], q = pairs[k][1], r = 3 - p - q;
      const float apq = s[3 * p + q];
      if (apq == 0.f) continue;
      const float theta = (s[3 * q + q] - s[3 * p + p]) / (2.f * apq);
      float t = fabsf(theta) > 1e18f
                    ? 0.5f / theta
                    : 1.f / (fabsf(theta) + sqrtf(theta * theta + 1.f));
      if (theta < 0.f && fabsf(theta) <= 1e18f) t = -t;
      const float c = 1.f / sqrtf(t * t + 1.f);
      const float sn = t * c;
      const float tau = sn / (1.f + c);
      s[3 * p + p] -= t * apq;
      s[3 * q + q] += t * apq;
      s[3 * p + q] = s[3 * q + p] = 0.f;
      const float g = s[3 * r + p], h = s[3 * r + q];
      s[3 * r + p] = s[3 * p + r] = g - sn * (h + g * tau);
      s[3 * r + q] = s[3 * q + r] = h + sn * (g - h * tau);
      for (int i = 0; i < 3; ++i) {
        const float vg = v[3 * i + p], vh = v[3 * i + q];
        v[3 * i + p] = vg - sn * (vh + vg * tau);
        v[3 * i + q] = vh + sn * (vg - vh * tau);
      }
    }
  }
  int j = 0;
  if (s[4] < s[3 * j + j]) j = 1;
  if (s[8] < s[3 * j + j]) j = 2;
  for (int i = 0; i < 3; ++i) v_out[i] = v[3 * i + j];
}

// The closest rotation q (row-major) to the cross-covariance abt:
// ops/procrustes.py::closest_rotation's recurrence (header).
__device__ void closest_rotation(const float* abt, float* q) {
  float m[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) m[3 * i + j] = abt[3 * j + i];
  float ss = 0.f;
  for (int k = 0; k < 9; ++k) ss += m[k] * m[k];
  const float norm = fmaxf(sqrtf(ss), 1e-30f);
  float x[9];
  for (int k = 0; k < 9; ++k) x[k] = m[k] / norm;
  if (fabsf(det3(x)) < 1e-6f) {
    x[0] += 1e-3f;
    x[4] += 1e-3f;
    x[8] += 1e-3f;
  }
  for (int step = 0; step < kNewtonSteps; ++step) {
    float z = rcbrtf(fmaxf(fabsf(det3(x)), 1e-12f));
    z = fminf(fmaxf(z, 1e-3f), 1e6f);
    float zx[9], c[9];
    for (int k = 0; k < 9; ++k) zx[k] = z * x[k];
    const float d = cofactors(zx, c);
    for (int k = 0; k < 9; ++k) x[k] = 0.5f * (zx[k] + c[k] / d);
  }
  if (det3(x) < 0.f) {
    // M^T M from the normalized M: the same eigenvectors, no underflow.
    float s[9];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        const float a0 = m[i] / norm, a1 = m[3 + i] / norm,
                    a2 = m[6 + i] / norm;
        const float b0 = m[j] / norm, b1 = m[3 + j] / norm,
                    b2 = m[6 + j] / norm;
        s[3 * i + j] = (a0 * b0 + a1 * b1) + a2 * b2;
      }
    float v[3];
    smallest_eigvec(s, v);
    float f[9];  // q (I - 2 v v^T)
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        const float rj0 = (j == 0 ? 1.f : 0.f) - 2.f * v[0] * v[j];
        const float rj1 = (j == 1 ? 1.f : 0.f) - 2.f * v[1] * v[j];
        const float rj2 = (j == 2 ? 1.f : 0.f) - 2.f * v[2] * v[j];
        f[3 * i + j] = (x[3 * i] * rj0 + x[3 * i + 1] * rj1) +
                       x[3 * i + 2] * rj2;
      }
    for (int k = 0; k < 9; ++k) x[k] = f[k];
  }
  for (int k = 0; k < 9; ++k) q[k] = x[k];
}

// (a b)[i] = (a[i][0] b[0] + a[i][1] b[1]) + a[i][2] b[2], a row-major.
__device__ __forceinline__ float row_dot(const float* a, int i, float b0,
                                         float b1, float b2) {
  return (a[3 * i] * b0 + a[3 * i + 1] * b1) + a[3 * i + 2] * b2;
}

// target [nt, 3]; idx [G, ns] i32; w [G, ns] or null; done [G] bool;
// cur [G, ns, 3] (in place); R [G, 3, 3], t [G, 3] (in place); last_R,
// last_t (written); running [1] (zeroed).
__global__ void align_kernel(const float* __restrict__ target,
                             const int* __restrict__ idx,
                             const float* __restrict__ w,
                             const bool* __restrict__ done, int ns,
                             float* __restrict__ cur, float* __restrict__ R,
                             float* __restrict__ t,
                             float* __restrict__ last_R,
                             float* __restrict__ last_t,
                             int* __restrict__ running) {
  __shared__ float part[kMaxWarps * 9];
  __shared__ float out[9];
  __shared__ float motion[12];  // Q row-major, then t_
  const int g = blockIdx.x;
  if (g == 0 && threadIdx.x == 0) *running = 0;
  if (done[g]) return;
  const long long base = static_cast<long long>(g) * ns;
  float* p = cur + 3 * base;
  const int* ix = idx + base;
  const float* wl = w == nullptr ? nullptr : w + base;

  float sums[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < ns; i += blockDim.x) {
    const float wi = wl == nullptr ? 1.f : wl[i];
    const float* c = target + 3LL * ix[i];
    sums[0] += wi;
    sums[1] += p[3 * i] * wi;
    sums[2] += p[3 * i + 1] * wi;
    sums[3] += p[3 * i + 2] * wi;
    sums[4] += c[0] * wi;
    sums[5] += c[1] * wi;
    sums[6] += c[2] * wi;
  }
  block_sum<7>(sums, part, out);
  const float wsum = fmaxf(sums[0], 1e-12f);
  const float ms0 = sums[1] / wsum, ms1 = sums[2] / wsum, ms2 = sums[3] / wsum;
  const float mc0 = sums[4] / wsum, mc1 = sums[5] / wsum, mc2 = sums[6] / wsum;

  float abt[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < ns; i += blockDim.x) {
    const float wi = wl == nullptr ? 1.f : wl[i];
    const float* c = target + 3LL * ix[i];
    const float a[3] = {(p[3 * i] - ms0) * wi, (p[3 * i + 1] - ms1) * wi,
                        (p[3 * i + 2] - ms2) * wi};
    const float b[3] = {c[0] - mc0, c[1] - mc1, c[2] - mc2};
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int k = 0; k < 3; ++k) abt[3 * r + k] += a[r] * b[k];
  }
  block_sum<9>(abt, part, out);

  if (threadIdx.x == 0) {
    float q[9];
    closest_rotation(abt, q);
    const float tq[3] = {mc0 - row_dot(q, 0, ms0, ms1, ms2),
                         mc1 - row_dot(q, 1, ms0, ms1, ms2),
                         mc2 - row_dot(q, 2, ms0, ms1, ms2)};
    float* Rg = R + 9LL * g;
    float* tg = t + 3LL * g;
    float r_old[9], t_old[3];
    for (int k = 0; k < 9; ++k) r_old[k] = last_R[9LL * g + k] = Rg[k];
    for (int k = 0; k < 3; ++k) t_old[k] = last_t[3LL * g + k] = tg[k];
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j)
        Rg[3 * i + j] = row_dot(q, i, r_old[j], r_old[3 + j], r_old[6 + j]);
      tg[i] = row_dot(q, i, t_old[0], t_old[1], t_old[2]) + tq[i];
    }
    for (int k = 0; k < 9; ++k) motion[k] = q[k];
    for (int k = 0; k < 3; ++k) motion[9 + k] = tq[k];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ns; i += blockDim.x) {
    const float x = p[3 * i], y = p[3 * i + 1], z = p[3 * i + 2];
#pragma unroll
    for (int r = 0; r < 3; ++r)
      p[3 * i + r] = row_dot(motion, r, x, y, z) + motion[9 + r];
  }
}

// d2 [G, ns]; w [G, ns] or null; done [G] bool (updated); sse, last_sse
// [G] (updated); running [1] (counted).
__global__ void commit_kernel(const float* __restrict__ d2,
                              const float* __restrict__ w, int ns,
                              float threshold, bool* __restrict__ done,
                              float* __restrict__ sse,
                              float* __restrict__ last_sse,
                              int* __restrict__ running) {
  __shared__ float part[kMaxWarps];
  __shared__ float out[1];
  const int g = blockIdx.x;
  if (done[g]) return;
  const long long base = static_cast<long long>(g) * ns;
  float s[1] = {0.f};
  for (int i = threadIdx.x; i < ns; i += blockDim.x)
    s[0] += w == nullptr ? d2[base + i] : d2[base + i] * w[base + i];
  block_sum<1>(s, part, out);
  if (threadIdx.x == 0) {
    const float prev = sse[g];
    last_sse[g] = prev;
    sse[g] = s[0];
    if (prev - s[0] <= threshold * prev)
      done[g] = true;
    else
      atomicAdd(running, 1);
  }
}

bool bad_block(int threads) {
  return threads < 32 || threads > kMaxThreads || threads % 32 != 0;
}

}  // namespace

extern "C" {

// One ICP alignment step of every lane not done (header), on the device of
// `stream`: G >= 1 lanes of ns >= 1 points, `threads` a multiple of 32 in
// [32, 1024] (the wrapper's plan for ns); w may be null.
int fgoicp_icp_align(const float* target, const int* idx, const float* w,
                     const bool* done, int G, int ns, int threads, float* cur,
                     float* R, float* t, float* last_R, float* last_t,
                     int* running, cudaStream_t stream) {
  if (G <= 0 || ns <= 0 || bad_block(threads))
    return static_cast<int>(cudaErrorInvalidValue);
  align_kernel<<<G, threads, 0, stream>>>(target, idx, w, done, ns, cur, R, t,
                                          last_R, last_t, running);
  return static_cast<int>(cudaGetLastError());
}

// The SSE, the masked sse / last_sse updates, the loop guard and the count
// of running lanes (header), on the device of `stream`.
int fgoicp_icp_commit(const float* d2, const float* w, int G, int ns,
                      int threads, float threshold, bool* done, float* sse,
                      float* last_sse, int* running, cudaStream_t stream) {
  if (G <= 0 || ns <= 0 || bad_block(threads))
    return static_cast<int>(cudaErrorInvalidValue);
  commit_kernel<<<G, threads, 0, stream>>>(d2, w, ns, threshold, done, sse,
                                           last_sse, running);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
