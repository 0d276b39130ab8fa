"""Exact nearest neighbour: the CUDA kernels (`csrc/nn.cu`) and their plain
torch versions.

Counterpart of the Pallas kernels `fgoicp_tpu/ops/pallas_nn.py::nn_argmin`
and `::nn_min`.  Both compute, per query, the exact f32 minimum of
(c - q)_x^2 + (c - q)_y^2 + (c - q)_z^2 over the target points by direct
differences (never the norm expansion), starting from BIG = 1e10 and keeping
the first index among equal minima.

Dispatch: tensors on the CPU go to the plain version; CUDA tensors launch the
kernel or raise — there is no fallback from the card to the plain version.
Each wrapper's `launches` attribute counts its kernel launches (the plain
path does not count), so a run can show that it went through the kernel,
and its `shapes` Counter the launches per (M, T).

On the card the targets may be cut into slices that separate blocks search
(`plan_splits`); the slices' partial minima are merged exactly by atomicMin
on (d2 bits, index) keys.
"""

from __future__ import annotations

import collections
import functools

import torch

from ..kernels import build

BIG = 1e10  # the kernels' initial running minimum (pallas_nn.BIG)

# The launch geometry of csrc/nn.cu: kThreads threads a block, kQ = 4
# queries a thread, at most 65,535 target slices (gridDim.y).
THREADS = 128
QUERY_TILE = 4 * THREADS
MAX_SPLITS = 65535
# The planner's aims: FILL blocks in flight on every SM (16 warps, 4 per
# scheduler, each with 4 independent queries, hide the arithmetic latency);
# no slice shorter than MIN_SLICE targets; a block's fixed cost (query
# loads, staging barrier, merge atomics) counted as BLOCK_COST targets.
FILL = 4
MIN_SLICE = 128
BLOCK_COST = 32

# Elements of one [queries, targets] distance block in the plain versions
# (a few such temporaries are alive at once).
_PLAIN_BLOCK = 1 << 24


def check_f32(name: str, **tensors) -> torch.device:
    """Common argument checks of the kernel wrappers: float32 (int32 for
    `gids` and `order`), contiguous, all on one device.  Returns that
    device."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    for key, t in tensors.items():
        want = torch.int32 if key in ("gids", "order") else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name}: {key} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    return devices.pop()


def _check_points(name: str, queries, points):
    if queries.ndim != 2 or queries.shape[1] != 3:
        raise ValueError(f"{name}: queries must be [M, 3], got {tuple(queries.shape)}")
    if points.ndim != 2 or points.shape[1] != 3 or points.shape[0] == 0:
        raise ValueError(f"{name}: points must be [T>0, 3], got {tuple(points.shape)}")
    if queries.shape[0] >= 2 ** 31 or points.shape[0] >= 2 ** 31:
        raise ValueError(f"{name}: sizes must fit in int32")
    return check_f32(name, queries=queries, points=points)


def _sq_dist_block(points, q):
    """[len(q), T] squared distances, rounded like the kernels:
    dx = c - q per axis, then (dx*dx + dy*dy) + dz*dz."""
    dx = points[None, :, 0] - q[:, 0:1]
    dy = points[None, :, 1] - q[:, 1:2]
    dz = points[None, :, 2] - q[:, 2:3]
    return dx * dx + dy * dy + dz * dz


def nn_argmin_plain(queries: torch.Tensor, points: torch.Tensor):
    """Plain torch version of `nn_argmin`, on any device: query-chunked
    direct differences; `torch.min` keeps the first index among ties."""
    m, t = queries.shape[0], points.shape[0]
    d2_out = torch.empty(m, dtype=torch.float32, device=queries.device)
    idx_out = torch.empty(m, dtype=torch.int32, device=queries.device)
    rows = max(1, _PLAIN_BLOCK // t)
    for s in range(0, m, rows):
        val, arg = torch.min(_sq_dist_block(points, queries[s:s + rows]), dim=1)
        # The kernels start from BIG with a strict `<`: a minimum that does
        # not beat BIG leaves (BIG, 0).
        beat = val < BIG
        d2_out[s:s + rows] = torch.where(beat, val, BIG)
        idx_out[s:s + rows] = torch.where(beat, arg, 0).to(torch.int32)
    return d2_out, idx_out


def nn_min_plain(queries: torch.Tensor, points: torch.Tensor):
    """Plain torch version of `nn_min`, on any device."""
    m, t = queries.shape[0], points.shape[0]
    d2_out = torch.empty(m, dtype=torch.float32, device=queries.device)
    rows = max(1, _PLAIN_BLOCK // t)
    for s in range(0, m, rows):
        val = torch.amin(_sq_dist_block(points, queries[s:s + rows]), dim=1)
        d2_out[s:s + rows] = torch.clamp(val, max=BIG)
    return d2_out


@functools.lru_cache(maxsize=1024)
def plan_splits(m: int, t: int, sms: int) -> tuple[int, int]:
    """(splits, chunk): the T targets cut into `splits` contiguous slices of
    `chunk` targets (the last one shorter, none empty) for M queries on a
    card of `sms` SMs.  The grid is ceil(M / QUERY_TILE) query tiles x
    splits blocks.

    A grid of FILL blocks per SM already fills the card: one slice, and the
    kernel writes its outputs directly.  Else each candidate slice count
    (slices of at least MIN_SLICE targets, at most 4 x FILL blocks per SM)
    is scored by its time on the busiest SM: the blocks it runs,
    ceil(blocks / sms), times each block's work, chunk + BLOCK_COST, scaled
    up by the share of FILL x sms blocks missing when the grid is smaller;
    the cheapest wins, the fewest slices on a tie."""
    tiles = -(-max(m, 1) // QUERY_TILE)
    full = FILL * sms
    if tiles >= full:
        return 1, t
    most = min(MAX_SPLITS, max(1, t // MIN_SLICE), -(-4 * full // tiles))
    best = (float("inf"), 1, t)
    for s in range(1, most + 1):
        chunk = -(-t // s)
        if -(-t // chunk) != s:  # the same slices as a smaller s
            continue
        blocks = tiles * s
        cost = -(-blocks // sms) * (chunk + BLOCK_COST) / min(1.0, blocks / full)
        if cost < best[0]:
            best = (cost, s, chunk)
    return best[1], best[2]


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan(device: torch.device, m: int, t: int) -> tuple[int, int]:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return plan_splits(m, t, _sm_count(index))


def nn_argmin(queries: torch.Tensor, points: torch.Tensor):
    """(d2 [M] f32, idx [M] i32) of the nearest target point per query.

    queries [M, 3], points [T, 3]: float32, contiguous, one device.
    Replaces `fgoicp_tpu/ops/pallas_nn.py::nn_argmin`."""
    device = _check_points("nn_argmin", queries, points)
    if device.type == "cpu":
        return nn_argmin_plain(queries, points)
    lib = build.load()
    m, t = queries.shape[0], points.shape[0]
    splits, chunk = _plan(device, m, t)
    d2 = torch.empty(m, dtype=torch.float32, device=device)
    idx = torch.empty(m, dtype=torch.int32, device=device)
    # The merge's workspace, only when the targets are split: [M] 64-bit
    # keys, then a counter of finished slices per query tile.  Freed on
    # return while the kernel may still run: the caching allocator reuses
    # it only in this stream's order.
    keys = torch.empty(m + -(-m // QUERY_TILE) if splits > 1 else 0,
                       dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        build.check(lib.fgoicp_nn_argmin(
            queries.data_ptr(), points.data_ptr(), m, t, splits, chunk,
            d2.data_ptr(), idx.data_ptr(), keys.data_ptr() or None, stream),
            "nn_argmin")
    nn_argmin.launches += 1
    nn_argmin.shapes[(m, t)] += 1
    return d2, idx


def nn_min(queries: torch.Tensor, points: torch.Tensor):
    """d2 [M] f32 of the nearest target point per query (no argmin).

    Replaces `fgoicp_tpu/ops/pallas_nn.py::nn_min`."""
    device = _check_points("nn_min", queries, points)
    if device.type == "cpu":
        return nn_min_plain(queries, points)
    lib = build.load()
    m, t = queries.shape[0], points.shape[0]
    splits, chunk = _plan(device, m, t)
    d2 = torch.empty(m, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        build.check(lib.fgoicp_nn_min(
            queries.data_ptr(), points.data_ptr(), m, t, splits, chunk,
            d2.data_ptr(), stream), "nn_min")
    nn_min.launches += 1
    nn_min.shapes[(m, t)] += 1
    return d2


nn_argmin.launches = 0
nn_min.launches = 0
nn_argmin.shapes = collections.Counter()
nn_min.shapes = collections.Counter()
