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
// What bounds it on the card: arithmetic, an add and a min per (line, i, j)
// triple that is evaluated, against 8 L n bytes of device memory.  No
// tensor-core form exists for the (min, +) semiring.  Most triples cannot
// win, so the kernel skips them exactly (below) and the work depends on the
// data: on an EDT most lines of the first pass are unseeded (all BIG), and
// in the later passes a cell's minimum comes from a window of about
// sqrt(g[i]) / res cells around it.
//
// Design.  A block owns 64 lines and walks all their outputs in tiles of
// 128; each thread keeps 8 lines x 4 consecutive outputs (32 running minima)
// in registers, a warp 8 lines x 128 outputs.  The block first writes the
// rounded cost of every difference it can meet into shared memory, and the
// minimum of g over every (line, chunk of 32 j) (gmin).  Each running
// minimum starts at its own j = i candidate, g[i] + cost(0).  The chunks of
// j are then visited from the tile's diagonal outward (the 4 chunks that
// hold j in [i0, i0 + 128) first, then alternately below and above), the
// same order in every thread, so the minima are tight before the far chunks
// are tested.  For a thread's outputs I on line l and a chunk J:
//     skip when fl(gmin[l, J] + cost(dmin)) >= max_{i in I} acc[l, i],
// with dmin the least |i - j| over I x J.  cost is monotone in |d| and each
// rounding is monotone, so fl(g[l, j] + cost(i - j)) >= fl(gmin + cost(dmin))
// >= acc[l, i] for every pair: the chunk cannot change those minima, and
// fminf of an equal value keeps the bits (no value here is -0: cost >= +0).
// After the table and gmin, each warp walks on its own, with no block
// barrier: it stages a line of a chunk (its row of [line][j] in shared
// memory) and evaluates it only when some thread of the warp needs that
// line, 4 j at a time: one broadcast float4 of the line's g and two float4
// of the costs they meet, then 16 adds and 16 mins.  At most 85 registers
// a thread (three blocks per SM) measured faster than 128 with the
// thread's 35 costs held in registers (two blocks).  Unseeded lines hold
// BIG everywhere, so their minima start at BIG and every chunk is skipped:
// their blocks read g twice and write it once.
//
// Ragged edges are masked, not padded in device memory: j >= n and lines
// >= L enter the staged chunk and gmin as +inf, which never wins a min;
// minima of outputs i >= n or lines >= L start at -inf (never changed,
// never needing a chunk) and are not stored.  Offsets into g and out are
// 64-bit (L * n can approach 2^31 on the largest fields).  Shared memory
// grows with n (about 16 n bytes + 9 KB; n up to about 13,000).
//
// Counters (optional): the triples evaluated (128 x 32 per (warp, line,
// chunk) evaluated, plus one per output for its j = i candidate) and the
// (warp, chunk) pairs staged.

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
constexpr int kDiagChunks = kTileOut / kChunkJ;                  // 4
constexpr int kRowStride = kChunkJ + 4;  // staged rows stay 16-byte aligned
constexpr int kBatch = 16;  // gmin loads in flight per warp

__host__ __device__ inline int padded_n(int n) {
  return (n + kChunkJ - 1) / kChunkJ * kChunkJ;
}

__host__ __device__ inline int n_tiles(int n) {
  return (n + kTileOut - 1) / kTileOut;
}

// Costs of every difference d in [-(n_pad - 1), tiles * 128 - 1], rounded up
// to a multiple of 4 floats so that gmin after it stays 16-byte aligned.
__host__ __device__ inline int table_floats(int n) {
  return (padded_n(n) - 1 + n_tiles(n) * kTileOut + 3) / 4 * 4;
}

// Shared memory: the cost table, gmin [n_pad / 32][64] and the warps' staged
// rows [64][kRowStride].
inline size_t smem_bytes(int n) {
  return sizeof(float) *
         (static_cast<size_t>(table_floats(n)) +
          static_cast<size_t>(padded_n(n) / kChunkJ) * kTileLines +
          static_cast<size_t>(kTileLines) * kRowStride);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kThreads, 3)
minplus_kernel(const float* __restrict__ g, float res, int lines, int n,
               unsigned long long* counts, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const float kInf = __int_as_float(0x7f800000);
  const int n_pad = padded_n(n);
  const int n_chunks = n_pad / kChunkJ;
  const int tiles = n_tiles(n);
  const int zero = n_pad - 1;  // table[zero + d] = cost(d)
  float* const table = reinterpret_cast<float*>(smem4);
  float* const gmin = table + table_floats(n);             // [chunk][line]
  float* const stage = gmin + n_chunks * kTileLines;       // [line][j]

  const int tid = threadIdx.x;
  const int og = tid % kOutGroups;  // lane: outputs og*4 .. og*4+3
  const int lg = tid / kOutGroups;  // warp: lines lg*8 .. lg*8+7
  const int64_t line0 = static_cast<int64_t>(blockIdx.x) * kTileLines;

  const int table_len = n_pad - 1 + tiles * kTileOut;
  for (int k = tid; k < table_len; k += kThreads) {
    const float c = __fmul_rn(static_cast<float>(k - zero), res);
    table[k] = __fmul_rn(c, c);
  }
  // gmin: warp lg reduces batches of kBatch consecutive (line, chunk) pairs
  // (pair p: line p / n_chunks, chunk p % n_chunks), its lanes on 32
  // consecutive j, so kBatch loads are in flight at once.
  const int pairs = kTileLines * n_chunks;
  for (int p0 = lg * kBatch; p0 < pairs; p0 += kThreads / 32 * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = p0 + u;
      const int64_t line = line0 + p / n_chunks;
      const int j = p % n_chunks * kChunkJ + og;
      v[u] = p < pairs && line < lines && j < n ? g[line * n + j] : kInf;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = p0 + u;
      const float mn = warp_min(v[u]);
      if (og == 0 && p < pairs)
        gmin[p % n_chunks * kTileLines + p / n_chunks] = mn;
    }
  }
  __syncthreads();

  unsigned long long triples = 0, staged = 0;
  for (int t = 0; t < tiles; ++t) {
    const int i0 = t * kTileOut;
    const int ia = i0 + og * kOutsPerThread;
    // Each minimum starts at its j = i candidate; -inf where not stored.
    float acc[kLinesPerThread][kOutsPerThread];
#pragma unroll
    for (int m = 0; m < kLinesPerThread; ++m) {
      const int64_t line = line0 + lg * kLinesPerThread + m;
#pragma unroll
      for (int k = 0; k < kOutsPerThread; ++k) {
        const int i = ia + k;
        acc[m][k] = line < lines && i < n
                        ? __fadd_rn(g[line * n + i], table[zero])
                        : -kInf;
      }
    }
    // Chunks from the diagonal outward: c0 .. c0 + 3, then c0 - 1,
    // c0 + 4, c0 - 2, c0 + 5, ... (those in range).
    const int c0 = i0 / kChunkJ;
    const int n_diag = min(kDiagChunks, n_chunks - c0);
    const int rings = max(c0, n_chunks - c0 - kDiagChunks);
    for (int s = 0; s < n_diag + 2 * rings; ++s) {
      int c;
      if (s < n_diag) {
        c = c0 + s;
      } else {
        const int r = (s - n_diag) / 2 + 1;
        c = ((s - n_diag) & 1) == 0 ? c0 - r : c0 + kDiagChunks - 1 + r;
      }
      if (c < 0 || c >= n_chunks) continue;  // the same in every thread
      const int j0 = c * kChunkJ;
      // The least |i - j| over the thread's outputs and the chunk.
      const int d_lo = ia - (j0 + kChunkJ - 1);
      const int d_hi = ia + kOutsPerThread - 1 - j0;
      const float cmin = table[zero + (d_lo > 0 ? d_lo : d_hi < 0 ? d_hi : 0)];
      const float4* gm =
          reinterpret_cast<const float4*>(gmin + c * kTileLines +
                                          lg * kLinesPerThread);
      const float4 ga = gm[0];
      const float4 gb = gm[1];
      const float gv[kLinesPerThread] = {ga.x, ga.y, ga.z, ga.w,
                                         gb.x, gb.y, gb.z, gb.w};
      // Bit m: some thread of the warp needs line m of the chunk.
      unsigned need = 0;
#pragma unroll
      for (int m = 0; m < kLinesPerThread; ++m) {
        const float amax = fmaxf(fmaxf(acc[m][0], acc[m][1]),
                                 fmaxf(acc[m][2], acc[m][3]));
        if (__fadd_rn(gv[m], cmin) < amax) need |= 1u << m;
      }
      need = __reduce_or_sync(0xffffffffu, need);
      if (need == 0) continue;
      // The warp stages the rows it needs, lane og at j = j0 + og.
      float* const rows = stage + lg * kLinesPerThread * kRowStride;
#pragma unroll
      for (int m = 0; m < kLinesPerThread; ++m) {
        const int64_t line = line0 + lg * kLinesPerThread + m;
        const int j = j0 + og;
        if (need >> m & 1)
          rows[m * kRowStride + og] =
              line < lines && j < n ? g[line * n + j] : kInf;
      }
      __syncwarp();
      if (og == 0) {
        ++staged;
        triples += static_cast<unsigned long long>(kTileOut) * kChunkJ *
                   __popc(need);
      }
      // Output k against j = j0 + 4 jq + e costs tb[31 + k - 4 jq - e]:
      // w[k - e + 3] of the 8 costs from tb[28 - 4 jq].
      const float* tb = table + zero + ia - j0 - (kChunkJ - 1);
#pragma unroll
      for (int jq = 0; jq < kChunkJ / 4; ++jq) {
        const float4 w0 =
            *reinterpret_cast<const float4*>(tb + kChunkJ - 4 - 4 * jq);
        const float4 w1 =
            *reinterpret_cast<const float4*>(tb + kChunkJ - 4 * jq);
        const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int m = 0; m < kLinesPerThread; ++m) {
          if (!(need >> m & 1)) continue;
          const float4 v =
              reinterpret_cast<const float4*>(rows + m * kRowStride)[jq];
          const float gj[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int k = 0; k < kOutsPerThread; ++k)
              acc[m][k] = fminf(acc[m][k], __fadd_rn(gj[e], w[k - e + 3]));
        }
      }
      __syncwarp();  // the rows are read before the next chunk's stores
    }
#pragma unroll
    for (int m = 0; m < kLinesPerThread; ++m) {
      const int64_t line = line0 + lg * kLinesPerThread + m;
      if (line >= lines) continue;
#pragma unroll
      for (int k = 0; k < kOutsPerThread; ++k) {
        const int i = ia + k;
        if (i < n) out[line * n + i] = acc[m][k];
      }
    }
  }
  if (counts != nullptr) {
    if (tid == 0) {
      const int64_t left = static_cast<int64_t>(lines) - line0;
      const int64_t valid = left < kTileLines ? left : kTileLines;
      triples += static_cast<unsigned long long>(valid) * n;  // j = i
    }
    if (og == 0) {
      atomicAdd(counts, triples);
      atomicAdd(counts + 1, staged);
    }
  }
}

}  // namespace

extern "C" {

// g [lines, n] f32 contiguous -> out [lines, n] f32, on the device of
// `stream`; n < 2^24 (differences exact in float32), lines < 2^31.
// counts (u64 [2] or null) gets the triples evaluated and the chunks staged
// added.
int fgoicp_minplus_1d(const float* g, float res, int lines, int n,
                      unsigned long long* counts, float* out,
                      cudaStream_t stream) {
  if (lines <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = smem_bytes(n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        minplus_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>(
      (static_cast<int64_t>(lines) + kTileLines - 1) / kTileLines);
  minplus_kernel<<<blocks, kThreads, smem, stream>>>(g, res, lines, n, counts,
                                                     out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
