// 1-D parabolic min-plus transform (the exact EDT's pass) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fgoicp_tpu/ops/pallas_minplus.py::minplus_1d
// (_kernel).  For g [L, n] float32 and a resolution res it computes
//     out[l, i] = min_j g[l, j] + cost(i - j),   cost(d) = ((float)d * res)^2
// rounded as the JAX package's production path distance_field._minplus_1d
// and the plain torch version (fgoicp_tpu_torch/ops/cuda_minplus.py) round
// it: c = (float)d * res, cost = c * c, then g + cost, each rounded on its
// own (__fmul_rn / __fadd_rn, and the library is built with --fmad=false).
// min is exact and does not depend on order, so the result equals the plain
// version bit for bit.  (The Pallas body rounds diff * diff * res^2
// instead; that is not the production formula.)
//
// What bounds it on the card: arithmetic.  Each (line, i, j) triple costs an
// add and a min, 2 L n^2 float32 operations against 8 L n bytes of device
// memory (n ~ 300 - 1,000 on the fields the engine builds), far above the
// H100's ~20 flops per byte.  No tensor-core form exists for the (min, +)
// semiring.
//
// Design.  The cost depends only on i - j, so a block first writes the
// rounded costs of every difference its tile can meet into shared memory.  A
// block owns 64 lines x 128 outputs and walks j in chunks of 32, staging the
// chunk of g (transposed, [j][line]) in shared memory.  Each thread keeps
// 8 lines x 4 consecutive outputs (32 running minima) in registers: per j it
// reads its 8 g values as two broadcast float4 loads and one new cost value
// (its 4 consecutive outputs need the costs of 4 consecutive differences,
// which slide by one as j advances), then does 32 adds and 32 mins.  The
// TPU kernel's [JSUB, LT, IT] broadcast in VMEM and its transposed input are
// Mosaic workarounds and are not carried over.
//
// Ragged edges are masked, not padded in device memory: lines >= L and
// j >= n enter the staged tile as +inf, which never wins a min (unseeded
// lines hold BIG = 1e10 and stay BIG + cost), and outputs i >= n or lines
// >= L are not stored.  Offsets into g and out are 64-bit (L * n can
// approach 2^31 on the largest fields).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kOutsPerThread = 4;
constexpr int kLinesPerThread = 8;
constexpr int kOutGroups = 32;  // one warp across the outputs of a tile
constexpr int kTileOut = kOutGroups * kOutsPerThread;            // 128
constexpr int kTileLines = (kThreads / kOutGroups) * kLinesPerThread;  // 64
constexpr int kChunkJ = 32;
constexpr int kLineStride = kTileLines + 4;  // staged rows stay 16-byte aligned

__host__ __device__ inline int padded_n(int n) {
  return (n + kChunkJ - 1) / kChunkJ * kChunkJ;
}

// Shared memory: the cost table (n_pad + 127 differences a tile meets, in a
// region of n_pad + 128 floats so that the staged tile after it stays
// 16-byte aligned) and one staged chunk of g.
inline size_t smem_bytes(int n) {
  return sizeof(float) * (static_cast<size_t>(padded_n(n)) + kTileOut +
                          static_cast<size_t>(kChunkJ) * kLineStride);
}

__global__ void __launch_bounds__(kThreads)
minplus_kernel(const float* __restrict__ g, float res, int lines, int n,
               float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* const table = reinterpret_cast<float*>(smem4);
  const int n_pad = padded_n(n);
  const int table_len = n_pad + kTileOut - 1;
  float* const tile = table + n_pad + kTileOut;

  const int tid = threadIdx.x;
  const int og = tid % kOutGroups;  // lane: outputs og*4 .. og*4+3
  const int lg = tid / kOutGroups;  // warp: lines lg*8 .. lg*8+7
  const int64_t line0 = static_cast<int64_t>(blockIdx.x) * kTileLines;
  const int i0 = blockIdx.y * kTileOut;

  // table[k] = cost(d) for d = k + i0 - (n_pad - 1): every i - j with i in
  // [i0, i0 + 128) and j in [0, n_pad).
  for (int k = tid; k < table_len; k += kThreads) {
    const float c = __fmul_rn(static_cast<float>(k + i0 - (n_pad - 1)), res);
    table[k] = __fmul_rn(c, c);
  }

  float acc[kLinesPerThread][kOutsPerThread];
#pragma unroll
  for (int m = 0; m < kLinesPerThread; ++m)
#pragma unroll
    for (int k = 0; k < kOutsPerThread; ++k) acc[m][k] = __int_as_float(0x7f800000);

  for (int j0 = 0; j0 < n_pad; j0 += kChunkJ) {
    __syncthreads();  // the table is written / the previous chunk consumed
    for (int e = tid; e < kTileLines * kChunkJ; e += kThreads) {
      const int jj = e % kChunkJ;
      const int r = e / kChunkJ;
      const int64_t line = line0 + r;
      const int j = j0 + jj;
      float v = __int_as_float(0x7f800000);
      if (line < lines && j < n) v = g[line * n + j];
      tile[jj * kLineStride + r] = v;
    }
    __syncthreads();

    // Costs of this thread's 4 outputs against j = j0 + jj sit at
    // table[base + k - jj]; w[k] holds them and slides by one per jj.
    const int base = og * kOutsPerThread - j0 + n_pad - 1;
    float w[kOutsPerThread];
#pragma unroll
    for (int k = 0; k < kOutsPerThread; ++k) w[k] = table[base + k];
#pragma unroll
    for (int jj = 0; jj < kChunkJ; ++jj) {
      const float4* row =
          reinterpret_cast<const float4*>(tile + jj * kLineStride + lg * kLinesPerThread);
      const float4 a = row[0];
      const float4 b = row[1];
      const float gv[kLinesPerThread] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int m = 0; m < kLinesPerThread; ++m)
#pragma unroll
        for (int k = 0; k < kOutsPerThread; ++k)
          acc[m][k] = fminf(acc[m][k], __fadd_rn(gv[m], w[k]));
      if (jj + 1 < kChunkJ) {
#pragma unroll
        for (int k = kOutsPerThread - 1; k > 0; --k) w[k] = w[k - 1];
        w[0] = table[base - jj - 1];
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kLinesPerThread; ++m) {
    const int64_t line = line0 + lg * kLinesPerThread + m;
    if (line >= lines) continue;
#pragma unroll
    for (int k = 0; k < kOutsPerThread; ++k) {
      const int i = i0 + og * kOutsPerThread + k;
      if (i < n) out[line * n + i] = acc[m][k];
    }
  }
}

}  // namespace

extern "C" {

// g [lines, n] f32 contiguous -> out [lines, n] f32, on the device of
// `stream`; n < 2^24 (differences exact in float32), lines < 2^31.
int fgoicp_minplus_1d(const float* g, float res, int lines, int n, float* out,
                      cudaStream_t stream) {
  if (lines <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = smem_bytes(n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        minplus_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((lines + kTileLines - 1) / kTileLines,
                  (n + kTileOut - 1) / kTileOut);
  minplus_kernel<<<grid, kThreads, smem, stream>>>(g, res, lines, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
