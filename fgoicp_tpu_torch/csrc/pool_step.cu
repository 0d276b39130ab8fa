// The pooled inner BnB's step bookkeeping in one launch, for Hopper
// (sm_90a): pool_commit.
//
// Replaces no TPU kernel: the JAX package's pooled step
// (fgoicp_tpu/ops/pool_frontier.py::bnb_r3_pooled) is XLA ops inside a
// lax.while_loop.  Its port's plain version (fgoicp_tpu_torch/ops/
// cuda_pool.py::pool_commit_plain) issues about 80 small ops a step from the
// host around the lane kernel (the one-hot incumbent update over [L, G], the
// octree split, four concatenations over CP + 7 L entries, a stable radix
// argsort and its gathers, two scatter minima, the counters), so on the card
// the host paces the step.  A step is now the lane kernel, pool_commit and
// one host read of the live flag it writes.
//
// What it computes, bit for bit as the plain "sort" update, from the state
// before the step (pool lbs, gids, centers, spans of CP slots; per group
// best_err, best_ub, best_t, active, evaluated, dropped_lb; the 0-d
// dropped) and the L = min(lanes, CP) lanes' bounds lb_e, ub_e:
//   1. lane validity: lb < INVALID, lb < best_err[gid], active[gid]; invalid
//      lanes' lb and ub become BIG;
//   2. per group the least lane ub and the first lane that attains it, as
//      torch.min(dim=0) over the [L, G] grid that holds BIG off the group:
//      the least of the 64-bit keys (orderable bits of ub << 32 | lane) of
//      the group's lanes and of (BIG, the first lane of another group),
//      taken by atomicMin in shared memory; then best_ub, improve, best_err
//      and best_t;
//   3. the twin share best_err = min(best_err, best_err[share]) and the
//      evaluated counts;
//   4. the split (valid, lb < best_err[gid], span >= min_span): child j of
//      lane p at center c + (+-half by the bits of j), span half = span / 2
//      (the signs are constants here, so split_octree's sign-table copy to
//      the device goes away);
//   5. the stable sort of [old entries CP - L, children 8 L] by lb, the
//      entries not kept (dominated, inactive group, INVALID) masked to
//      INVALID, done as a merge that lands every entry at the place
//      argsort(stable=True) gives it, the first CP kept.  Three facts make
//      it exact:
//      (a) the kept old entries are nondecreasing in index order: every step
//          leaves the pool sorted (kept keys ascending, then INVALID), and
//          the first pool's kept entries are its roots, all at lb 0;
//      (b) a parent's 8 children share its key and gid, so they are kept
//          together, exactly where the parent split; the children sort as
//          a stable sort of the L parent keys (a bitonic sort of the 64-bit
//          (orderable key, parent) pairs) repeated 8-fold;
//      (c) ranks: a kept old entry at old index i goes to (kept old entries
//          before i) + 8 x (kept parents with a smaller key): old entries
//          first on ties, as the stable sort keeps them; a kept parent at
//          sorted place q puts its child j at (kept old entries with key <=
//          its key) + 8 q + j, and that count is the number of kept old
//          entries whose parent count c is <= q, a prefix of the histogram
//          of c; the entries not kept follow in index order, old entries
//          first, then children by 8 p + j, with their gid, center and
//          span;
//      then dropped (kept entries past CP), dropped_lb (the group minimum of
//      their keys), minlb (the group minimum of the new pool), converged,
//      empty and the new active; the live flag (any group active), and the
//      next step's lane inputs: the first L slots' gid as int32 and
//      gam_t = sqrt3 x span.
// Every key comparison of the sort uses the orderable bits of the float, as
// the radix sort does (-0 before +0); every other comparison is a float
// comparison, as the torch ops make it.  The group minima are atomicMin of
// the same bits, decoded back to the value.
//
// What bounds it.  Bytes: the pool read and written (28 B a slot: lb, gid
// int64, center, span) and the lanes' bounds, about 1.9 MB at CP 32,768,
// L 1,024, 0.6 us at 3.35 TB/s; the work is a few integer operations and a
// binary search a slot.  A step's pieces depend on one another (the
// incumbents on every lane, the split on the shared incumbents, every rank
// on the counts before it), so its time is latency: barriers, and global
// loads that one SM cannot keep enough of in flight alone.
//
// Design.  A thread-block cluster of C blocks (the wrapper's plan, 1 to 8)
// of kThreads threads.  Each block repeats steps 1-4 and the parents' sort
// for itself (about L + G work, in its own shared memory); the block that
// owns group g (a slice of the groups) writes its per-group outputs.  The
// old entries split into C contiguous ranges: each block counts its kept
// entries, the blocks read each other's counts through distributed shared
// memory for their offsets, then each places its range (block-wide ballot
// prefix counts, kBatch rows of loads in flight) and keeps its histogram of
// c and its group minima; the children (a slice of the parents a block)
// read the blocks' histogram prefixes, and the owners of the groups read
// the blocks' minima.  Five cluster barriers.  The workspace (per group:
// keys, minima, incumbents, counts; per lane: bounds, places, the sort keys,
// the histogram) lives in dynamic shared memory while it fits the limit the
// wrapper passes, else each block's lives in a global scratch; nothing is
// sorted in place: the new state goes to the other of two buffers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;          // rows of old entries loaded at once
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kMaxDevices = 64;
constexpr float kInvalid = 1e30f;  // ops/cuda_pool.py's INVALID, as float32
constexpr float kBig = 1e10f;      // BIG
constexpr unsigned kFull = 0xffffffffu;
using u64 = unsigned long long;

// The float's bits mapped so that unsigned order is the float order (the
// radix sort's map); unord inverts it.
__device__ __forceinline__ unsigned ord(float x) {
  const unsigned b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float unord(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}
__device__ __forceinline__ u64 key_of(float v, int i) {
  return (static_cast<u64>(ord(v)) << 32) | static_cast<unsigned>(i);
}
// torch.minimum: NaN propagates.
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}

struct Pool {
  float* lbs;
  long long* gids;
  float* centers;
  float* spans;
  float* best_err;
  float* best_ub;
  float* best_t;
  bool* active;
  long long* evaluated;
  long long* dropped;
  float* dropped_lb;
};

struct Args {
  Pool in, out;
  const float* lb_e;
  const float* ub_e;
  const long long* share;  // null: no twin share
  int* lane_gid;
  float* gam_t;
  int* live;
  int G, cp, nl, P2;
  float min_span, threshold, sqrt3;
  unsigned char* scratch;
  long long ws_bytes;
};

// One block's workspace (the wrapper's workspace_bytes counts the same).
struct Ws {
  u64* gkey;      // [G] least (ub, lane) key of the group
  u64* pkey;      // [P2] parents' sort keys, then sorted
  unsigned* gmin;   // [G] least key of the new pool's entries (ord bits)
  unsigned* gdrop;  // [G] least key of the kept entries past CP
  float* err1;    // [G] best_err after the incumbents
  float* gerr;    // [G] ... and after the twin share
  int* gcnt;      // [G] valid lanes
  float* lane_lb; // [nl] lanes' lb, BIG where invalid
  float* lane_ub; // [nl] lanes' ub, BIG where invalid
  int* place;     // [nl] kept parent: sorted place q; else ~(not-kept before)
  int* hist;      // [nl + 1] kept old entries by parent count c, then prefix
};

__host__ __device__ inline long long ws_bytes(int G, int nl, int P2) {
  const long long b = 8LL * (G + P2) + 4LL * (5LL * G + 4LL * nl + 1);
  return (b + 15) / 16 * 16;
}

__device__ inline Ws carve(unsigned char* p, int G, int nl, int P2) {
  Ws w;
  w.gkey = reinterpret_cast<u64*>(p);
  w.pkey = w.gkey + G;
  w.gmin = reinterpret_cast<unsigned*>(w.pkey + P2);
  w.gdrop = w.gmin + G;
  w.err1 = reinterpret_cast<float*>(w.gdrop + G);
  w.gerr = w.err1 + G;
  w.gcnt = reinterpret_cast<int*>(w.gerr + G);
  w.lane_lb = reinterpret_cast<float*>(w.gcnt + G);
  w.lane_ub = w.lane_lb + nl;
  w.place = reinterpret_cast<int*>(w.lane_ub + nl);
  w.hist = w.place + nl;
  return w;
}

// Exclusive prefix count of f over the block's threads in order, after
// *carry; *carry then grows by the block's count (written after the second
// barrier: read it only after a later one).
__device__ int block_count(bool f, int* tot, int* carry) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned b = __ballot_sync(kFull, f);
  if (lane == 0) tot[warp] = __popc(b);
  __syncthreads();
  int before = *carry, all = 0;
  for (int k = 0; k < kWarps; ++k) {
    const int c = tot[k];
    before += k < warp ? c : 0;
    all += c;
  }
  __syncthreads();
  if (threadIdx.x == 0) *carry += all;
  return before + __popc(b & ((1u << lane) - 1u));
}

// Inclusive prefix sum of v over the block's threads in order, after
// *carry (as block_count).
__device__ int block_scan(int v, int* tot, int* carry) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) tot[warp] = v;
  __syncthreads();
  int before = *carry, all = 0;
  for (int k = 0; k < kWarps; ++k) {
    const int c = tot[k];
    before += k < warp ? c : 0;
    all += c;
  }
  __syncthreads();
  if (threadIdx.x == 0) *carry += all;
  return before + v;
}

// Ascending bitonic sort of a[0, n), n a power of two, by the block.
__device__ void bitonic_sort(u64* a, int n) {
  for (int k = 2; k <= n; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n / 2; i += kThreads) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const u64 x = a[lo], y = a[hi];
        if ((x > y) == ((lo & k) == 0)) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncthreads();
    }
}

// The number of a[0, n) below t (a ascending).
__device__ __forceinline__ int count_below(const u64* a, int n, u64 t) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < t)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Block r's copy of this block's workspace array p.
template <bool kShared, typename T>
__device__ __forceinline__ T* peer(cg::cluster_group& cl, T* p, int r,
                                   int rank, long long stride) {
  if (kShared) return cl.map_shared_rank(p, r);
  return reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(p) +
                              (r - rank) * stride);
}

// Slot r of the new pool takes (lb, gid, center, span); the first nl slots
// are also the next step's lanes.
__device__ __forceinline__ void put(const Args& a, int r, float lb,
                                    long long gid, float cx, float cy,
                                    float cz, float span) {
  a.out.lbs[r] = lb;
  a.out.gids[r] = gid;
  a.out.centers[3LL * r] = cx;
  a.out.centers[3LL * r + 1] = cy;
  a.out.centers[3LL * r + 2] = cz;
  a.out.spans[r] = span;
  if (r < a.nl) {
    a.lane_gid[r] = static_cast<int>(gid);
    a.gam_t[r] = __fmul_rn(a.sqrt3, span);
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
    pool_commit_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int tot[kWarps];
  __shared__ int carry[3];  // not-kept parents, kept old entries, histogram
  __shared__ int s_first_other, s_kpar, s_kold, s_live;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int C = static_cast<int>(cl.num_blocks());
  const int tid = threadIdx.x, lane = tid & 31;
  const int G = a.G, cp = a.cp, nl = a.nl, M = cp - nl;
  const Pool& in = a.in;
  unsigned char* base =
      kShared ? smem : a.scratch + static_cast<long long>(rank) * a.ws_bytes;
  const Ws w = carve(base, G, nl, a.P2);
  const long long gid0 = in.gids[0];
  const int glo = static_cast<int>(static_cast<long long>(G) * rank / C);
  const int ghi = static_cast<int>(static_cast<long long>(G) * (rank + 1) / C);

  // 0. The workspace.
  for (int g = tid; g < G; g += kThreads) {
    w.gkey[g] = g != gid0 ? key_of(kBig, 0) : ~0ULL;
    w.gmin[g] = w.gdrop[g] = ord(kInvalid);
    w.gcnt[g] = 0;
  }
  for (int p = tid; p < a.P2; p += kThreads) w.pkey[p] = ~0ULL;
  for (int q = tid; q <= nl; q += kThreads) w.hist[q] = 0;
  if (tid == 0) {
    s_first_other = 0x7fffffff;
    s_kpar = s_kold = s_live = 0;
    carry[0] = carry[2] = 0;
  }
  __syncthreads();

  // 1. Lane validity, the groups' least (ub, lane) keys, valid lane counts.
  // Off its group a lane holds BIG: lane 0 for every group but gid0's, the
  // first lane of another group for gid0's.
  for (int l0 = 0; l0 < nl; l0 += kThreads) {
    const int l = l0 + tid;
    long long gid = gid0;
    if (l < nl) {
      gid = in.gids[l];
      const float lb = in.lbs[l];
      const bool valid = lb < kInvalid && lb < in.best_err[gid] &&
                         in.active[gid];
      const float lbm = valid ? a.lb_e[l] : kBig;
      const float ubm = valid ? a.ub_e[l] : kBig;
      w.lane_lb[l] = lbm;
      w.lane_ub[l] = ubm;
      atomicMin(&w.gkey[gid], key_of(ubm, l));
      if (valid) atomicAdd(&w.gcnt[gid], 1);
    }
    const unsigned other = __reduce_min_sync(
        kFull, (l < nl && gid != gid0) ? static_cast<unsigned>(l)
                                       : 0x7fffffffu);
    if (lane == 0 && other != 0x7fffffffu)
      atomicMin(&s_first_other, static_cast<int>(other));
  }
  __syncthreads();
  if (tid == 0 && s_first_other != 0x7fffffff)
    atomicMin(&w.gkey[gid0], key_of(kBig, s_first_other));
  __syncthreads();

  // 2. Incumbents; the owner of g writes best_ub, best_t, evaluated.
  for (int g = tid; g < G; g += kThreads) {
    const int l = static_cast<int>(static_cast<unsigned>(w.gkey[g]));
    const float v = in.gids[l] == g ? w.lane_ub[l] : kBig;
    const bool act = in.active[g];
    const float be = in.best_err[g];
    const bool improve = act && v < be;
    w.err1[g] = improve ? v : be;
    if (g >= glo && g < ghi) {
      a.out.best_ub[g] = act ? tmin(in.best_ub[g], v) : in.best_ub[g];
      for (int k = 0; k < 3; ++k)
        a.out.best_t[3 * g + k] =
            improve ? in.centers[3LL * l + k] : in.best_t[3 * g + k];
      a.out.evaluated[g] = in.evaluated[g] + w.gcnt[g];
    }
  }
  __syncthreads();

  // 3. The twin share.
  for (int g = tid; g < G; g += kThreads) {
    float be = w.err1[g];
    if (a.share != nullptr) {
      const long long s = a.share[g];
      if (s >= 0) be = tmin(be, w.err1[s]);
    }
    w.gerr[g] = be;
    if (g >= glo && g < ghi) a.out.best_err[g] = be;
  }
  __syncthreads();

  // 4. The split: kept parents' sort keys, the others' places.
  for (int l0 = 0; l0 < nl; l0 += kThreads) {
    const int l = l0 + tid;
    bool kept = false;
    if (l < nl) {
      const long long gid = in.gids[l];
      const float lb = in.lbs[l];
      const bool valid = lb < kInvalid && lb < in.best_err[gid] &&
                         in.active[gid];
      const float lbm = w.lane_lb[l];
      const bool split = valid && lbm < w.gerr[gid] &&
                         in.spans[l] >= a.min_span;
      const float key = split ? lbm : kInvalid;
      kept = key < kInvalid && key < w.gerr[gid] && in.active[gid];
      w.pkey[l] = kept ? key_of(key, l) : ~0ULL;
    }
    const int before = block_count(l < nl && !kept, tot, &carry[0]);
    if (l < nl && !kept) w.place[l] = ~before;
    const unsigned k = __ballot_sync(kFull, kept);
    if (lane == 0 && k) atomicAdd(&s_kpar, __popc(k));
  }
  __syncthreads();
  const int kpar = s_kpar;
  bitonic_sort(w.pkey, a.P2);
  for (int q = tid; q < kpar; q += kThreads)
    w.place[static_cast<unsigned>(w.pkey[q])] = q;

  // 5. This block's range of old entries: count the kept ones.
  const int olo = static_cast<int>(static_cast<long long>(M) * rank / C);
  const int ohi = static_cast<int>(static_cast<long long>(M) * (rank + 1) / C);
  auto keep = [&](float lb, long long gid) {
    return lb < kInvalid && lb < w.gerr[gid] && in.active[gid];
  };
  {
    int mine = 0;
    for (int i0 = olo; i0 < ohi; i0 += kThreads * kBatch) {
      float lb[kBatch];
      long long gid[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = i0 + b * kThreads + tid;
        lb[b] = i < ohi ? in.lbs[nl + i] : kInvalid;
        gid[b] = i < ohi ? in.gids[nl + i] : 0;
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) mine += keep(lb[b], gid[b]);
    }
    for (int o = 16; o > 0; o >>= 1) mine += __shfl_down_sync(kFull, mine, o);
    if (lane == 0 && mine) atomicAdd(&s_kold, mine);
  }
  cl.sync();
  int kold = 0, kold_before = 0;
  for (int r = 0; r < C; ++r) {
    const int k = *cl.map_shared_rank(&s_kold, r);
    kold += k;
    kold_before += r < rank ? k : 0;
  }
  const int n_valid = kold + 8 * kpar;
  if (tid == 0) carry[1] = kold_before;
  __syncthreads();

  // 6. Place the range: kept entries at (kept before) + 8 c, the others in
  // the INVALID tail.
  for (int i0 = olo; i0 < ohi; i0 += kThreads * kBatch) {
    float lb[kBatch];
    long long gid[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kThreads + tid;
      lb[b] = i < ohi ? in.lbs[nl + i] : kInvalid;
      gid[b] = i < ohi ? in.gids[nl + i] : 0;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kThreads + tid;
      const bool kept = i < ohi && keep(lb[b], gid[b]);
      const int before = block_count(kept, tot, &carry[1]);
      const long long src = static_cast<long long>(nl) + i;
      int c = -1;
      if (kept) {
        c = count_below(w.pkey, kpar, static_cast<u64>(ord(lb[b])) << 32);
        const long long r = before + 8LL * c;
        if (r < cp) {
          put(a, static_cast<int>(r), lb[b], gid[b], in.centers[3 * src],
              in.centers[3 * src + 1], in.centers[3 * src + 2],
              in.spans[src]);
          atomicMin(&w.gmin[gid[b]], ord(lb[b]));
        } else {
          atomicMin(&w.gdrop[gid[b]], ord(lb[b]));
        }
      } else if (i < ohi) {
        const long long r = static_cast<long long>(n_valid) + (i - before);
        if (r < cp)
          put(a, static_cast<int>(r), kInvalid, gid[b], in.centers[3 * src],
              in.centers[3 * src + 1], in.centers[3 * src + 2],
              in.spans[src]);
      }
      const unsigned same = __match_any_sync(kFull, c);
      if (c >= 0 && lane == __ffs(same) - 1)
        atomicAdd(&w.hist[c], __popc(same));
    }
  }
  __syncthreads();
  // The histogram's inclusive prefix over c in [0, kpar].
  for (int q0 = 0; q0 <= kpar; q0 += kThreads) {
    const int q = q0 + tid;
    const int s = block_scan(q <= kpar ? w.hist[q] : 0, tot, &carry[2]);
    if (q <= kpar) w.hist[q] = s;
  }
  cl.sync();

  // 7. This block's slice of the parents: their children.
  const long long stride = a.ws_bytes;
  const int plo = static_cast<int>(static_cast<long long>(nl) * rank / C);
  const int phi = static_cast<int>(static_cast<long long>(nl) * (rank + 1) / C);
  for (int p = plo + tid; p < phi; p += kThreads) {
    const int q = w.place[p];
    const long long gid = in.gids[p];
    const float half = __fmul_rn(in.spans[p], 0.5f);
    const float c0 = in.centers[3LL * p], c1 = in.centers[3LL * p + 1],
                c2 = in.centers[3LL * p + 2];
    long long r0;
    float lb = kInvalid;
    if (q >= 0) {
      int h = 0;
      for (int r = 0; r < C; ++r)
        h += peer<kShared>(cl, w.hist, r, rank, stride)[q];
      r0 = h + 8LL * q;
      lb = w.lane_lb[p];
    } else {
      r0 = static_cast<long long>(n_valid) + (M - kold) + 8LL * (~q);
    }
    for (int j = 0; j < 8; ++j) {
      const long long r = r0 + j;
      if (r < cp) {
        put(a, static_cast<int>(r), lb, gid,
            __fadd_rn(c0, (j & 1) ? half : -half),
            __fadd_rn(c1, (j & 2) ? half : -half),
            __fadd_rn(c2, (j & 4) ? half : -half), half);
        if (q >= 0) atomicMin(&w.gmin[gid], ord(lb));
      } else if (q >= 0) {
        atomicMin(&w.gdrop[gid], ord(lb));
      }
    }
  }
  __syncthreads();
  cl.sync();

  // 8. The owner's groups: minima over the blocks, dropped_lb, active.
  int live = 0;
  for (int g = glo + tid; g < ghi; g += kThreads) {
    unsigned mn = ~0u, dr = ~0u;
    for (int r = 0; r < C; ++r) {
      mn = min(mn, peer<kShared>(cl, w.gmin, r, rank, stride)[g]);
      dr = min(dr, peer<kShared>(cl, w.gdrop, r, rank, stride)[g]);
    }
    const float minlb = unord(mn);
    a.out.dropped_lb[g] = tmin(in.dropped_lb[g], unord(dr));
    const bool converged = __fsub_rn(w.gerr[g], minlb) < a.threshold;
    const bool empty = minlb >= kInvalid;
    const bool act = in.active[g] && !(converged || empty);
    a.out.active[g] = act;
    live |= act;
  }
  live = __syncthreads_or(live);
  if (tid == 0) s_live = live;
  cl.sync();
  if (rank == 0 && tid == 0) {
    int any = 0;
    for (int r = 0; r < C; ++r) any |= *cl.map_shared_rank(&s_live, r);
    *a.live = any;
    const long long over = static_cast<long long>(n_valid) - cp;
    *a.out.dropped = *in.dropped + (over > 0 ? over : 0);
  }
  cl.sync();  // no block leaves while another reads its shared memory
}

// Raise the shared-kernel's dynamic shared-memory limit to `limit`, once per
// device (again only for a larger limit).
cudaError_t configure(int limit) {
  static std::atomic<int> set_to[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && set_to[dev].load() >= limit) return cudaSuccess;
  err = cudaFuncSetAttribute(pool_commit_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             limit);
  if (err == cudaSuccess && dev < kMaxDevices) set_to[dev].store(limit);
  return err;
}

}  // namespace

extern "C" {

// One pooled step's bookkeeping (header), on the device of `stream`.  The
// input state (lbs, gids, centers, spans [cp]; best_err, best_ub, best_t,
// active, evaluated, dropped_lb [G]; dropped [1]) and the lanes' lb_e, ub_e
// [nl] are read; the output state (the same shapes, other buffers), the
// next lanes' lane_gid (int32) and gam_t [nl] and live [1] are written.
// share [G] int64 or null.  1 <= nl <= cp, cp + 8 nl < 2^31, G >= 1;
// cluster in [1, 8]; the workspace in dynamic shared memory when
// ws_bytes <= smem_limit, else in scratch (cluster x ws_bytes bytes).
int fgoicp_pool_commit(
    const float* lbs, const long long* gids, const float* centers,
    const float* spans, const float* best_err, const float* best_ub,
    const float* best_t, const bool* active, const long long* evaluated,
    const long long* dropped, const float* dropped_lb, const float* lb_e,
    const float* ub_e, const long long* share, int G, int cp, int nl,
    float min_span, float threshold, float sqrt3, int cluster,
    int smem_limit, void* scratch, float* o_lbs, long long* o_gids,
    float* o_centers, float* o_spans, float* o_best_err, float* o_best_ub,
    float* o_best_t, bool* o_active, long long* o_evaluated,
    long long* o_dropped, float* o_dropped_lb, int* lane_gid, float* gam_t,
    int* live, cudaStream_t stream) {
  if (G <= 0 || nl <= 0 || nl > cp ||
      static_cast<long long>(cp) + 8LL * nl >= (1LL << 31) || cluster < 1 ||
      cluster > kMaxCluster || smem_limit < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int P2 = 1;
  while (P2 < nl) P2 <<= 1;
  const long long bytes = ws_bytes(G, nl, P2);
  const bool shared = bytes <= smem_limit;
  if (!shared && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.in = Pool{const_cast<float*>(lbs), const_cast<long long*>(gids),
              const_cast<float*>(centers), const_cast<float*>(spans),
              const_cast<float*>(best_err), const_cast<float*>(best_ub),
              const_cast<float*>(best_t), const_cast<bool*>(active),
              const_cast<long long*>(evaluated),
              const_cast<long long*>(dropped),
              const_cast<float*>(dropped_lb)};
  a.out = Pool{o_lbs, o_gids, o_centers, o_spans, o_best_err, o_best_ub,
               o_best_t, o_active, o_evaluated, o_dropped, o_dropped_lb};
  a.lb_e = lb_e;
  a.ub_e = ub_e;
  a.share = share;
  a.lane_gid = lane_gid;
  a.gam_t = gam_t;
  a.live = live;
  a.G = G;
  a.cp = cp;
  a.nl = nl;
  a.P2 = P2;
  a.min_span = min_span;
  a.threshold = threshold;
  a.sqrt3 = sqrt3;
  a.scratch = static_cast<unsigned char*>(scratch);
  a.ws_bytes = bytes;
  if (shared) {
    const cudaError_t err = configure(smem_limit);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = shared ? static_cast<size_t>(bytes) : 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      shared ? cudaLaunchKernelEx(&cfg, pool_commit_kernel<true>, a)
             : cudaLaunchKernelEx(&cfg, pool_commit_kernel<false>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
