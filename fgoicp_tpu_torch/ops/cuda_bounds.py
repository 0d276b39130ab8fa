"""Fused bound evaluation: the CUDA kernels (`csrc/bounds_lanes.cu`,
`csrc/bounds_grid.cu`, `csrc/bounds_lanes_trimmed.cu`) and their plain
torch versions.

Counterparts of the Pallas kernels in `fgoicp_tpu/ops/pallas_bounds.py`.
For a node with group g, translation t and translation radius gam_t, and
every source point i:

    q    = base[g, i] + t
    d    = sqrt(max(min(BIG, min_p ||c_p - q||^2), 0))
    ut_i = w_i * relu(d - gam_ub[g, i])^2
    lt_i = w_i * relu(d - slack - gam_lb[g, i] - gam_t)^2

`fused_bounds_lanes` (the pooled frontier's lanes, one node per lane) and
`fused_bounds` (the grouped scheduler's [G, B] grid of nodes) return
ub = sum_i ut_i and lb = sum_i lt_i.  `fused_bounds_lanes_trimmed` (the
pooled frontier's trimmed lanes) leaves out of each sum a bracket of its
n_drop largest terms (`kept_sum`).

Dispatch: CPU tensors go to the plain version; CUDA tensors launch the
kernel or raise.  Each wrapper's `launches` counts its kernel launches.
Inside a request (utils/trace.py) each launch adds its pairs and box
tests to the request's device counts and its argument bytes to the
request's "bound_bytes".
The kernels compute the terms bit for bit as the plain versions do; only
the order of the final sums over i differs, hence the rtol 2e-4 /
atol 2e-5 they are compared at (the JAX package's tolerance between its
Pallas kernels and XLA path).

All three kernels find the nearest proxy by an exact box-pruned search
(csrc/bounds_terms.cuh): the proxies sorted by a Morton code,
refined by median splits into compact buckets of BUCKET, each with its box
(`proxy_buckets`), and the source points taken by each warp in runs of
WARP_POINTS of an order (`source_order`).  Building the buckets takes
longer than the kernel, so the proxies' owner builds them once
(`bounds.ProxyBackend.buckets`) and passes them as `proxies`; a bare
proxies tensor is bucketed on every CUDA call.  The source order is fixed
for a source, so its owner (GoICP) builds it once and passes it as
`point_order`; without one the warps take the points as they come.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import build
from ..parallel.sharding import sharded
from ..utils import debug, trace
from .cuda_nn import BIG, check_f32

# Elements of one [lanes, ns, P] distance block in the plain versions.
_PLAIN_BLOCK = 1 << 24
BISECT_ITERS = 26
# The pruned search's layout (csrc/bounds_terms.cuh): proxies per bucket
# (kBucket), source points per warp (32 x kPrunedPerThread), the bits per
# axis of the Morton codes, and the most median splits of `_kd_refine`.
BUCKET = 32
WARP_POINTS = 64
MORTON_BITS = 10
KD_LEVELS = 5


def morton_codes(points: torch.Tensor) -> torch.Tensor:
    """Z-order (Morton) codes [n] int64 of points [n, 3]: each coordinate
    quantised to 2^MORTON_BITS cells of the points' own box, the bits of
    the three axes interleaved (x lowest).  Points close in the code are
    close in space; the same points give the same codes on every device."""
    dev = points.device
    if points.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    top = 2 ** MORTON_BITS - 1
    lo, hi = torch.aminmax(points, dim=0)
    unit = (points - lo) / torch.clamp(hi - lo, min=1e-30)     # in [0, 1]
    cells = (unit * top).to(torch.int64).clamp_(0, top)
    shifts = torch.arange(MORTON_BITS, device=dev)
    bits = (cells[:, :, None] >> shifts) & 1                  # [n, 3, bits]
    place = 3 * shifts + torch.arange(3, device=dev)[:, None]  # [3, bits]
    return torch.sum(bits << place, dim=(1, 2))


def _kd_refine(order: torch.Tensor, points: torch.Tensor,
               leaf: int) -> torch.Tensor:
    """`order` (a Morton order of points [n, 3]) with each aligned run of
    leaf * 2^k entries (k <= KD_LEVELS, as many as the points fill) split k
    times at the median of its longest axis, so that every run of `leaf`
    entries is a kd-tree leaf.  A Morton run can straddle the boundary of
    two distant cells and give a long box; a leaf is compact.  Entries after
    the last full run keep the Morton order.  Deterministic: stable sorts,
    first index among equal extents."""
    n = order.shape[0]
    levels = min(KD_LEVELS, (n // leaf).bit_length() - 1)
    if levels <= 0:
        return order
    span = leaf << levels
    full = n // span * span
    runs = order[:full].view(-1, span)
    for level in range(levels):
        seg = runs.view(-1, span >> level)
        p = points[seg]                                  # [segments, len, 3]
        lo, hi = torch.aminmax(p, dim=1)
        axis = torch.argmax(hi - lo, dim=1)
        key = torch.gather(p, 2, axis[:, None, None].expand(-1, p.shape[1],
                                                            1))[..., 0]
        runs = torch.gather(seg, 1, torch.argsort(key, dim=1, stable=True))
        runs = runs.view(-1, span)
    return torch.cat([runs.view(-1), order[full:]])


def spatial_order(points: torch.Tensor, leaf: int) -> torch.Tensor:
    """[n] int64 permutation of points [n, 3]: a stable Morton order
    refined by `_kd_refine` into compact runs of `leaf` points."""
    return _kd_refine(torch.argsort(morton_codes(points), stable=True),
                      points, leaf)


class ProxyBuckets(NamedTuple):
    """Proxies as the bound kernels search them: `points` [P, 3]
    as given (what the plain versions scan), `rows` [nb * BUCKET, 3] and
    `boxes` [nb, 6] built from them by `proxy_buckets`."""
    points: torch.Tensor
    rows: torch.Tensor
    boxes: torch.Tensor


def proxy_buckets(proxies: torch.Tensor) -> ProxyBuckets:
    """The proxies [P, 3] in nb = ceil(P / BUCKET) buckets for the pruned
    search.  rows holds the proxies in `spatial_order`, the ragged last
    bucket padded with copies of its own last member (a copy cannot change
    a minimum, where a far sentinel would stretch the box); boxes the exact
    (lo xyz, hi xyz) of each bucket's members."""
    n = proxies.shape[0]
    nb = -(-n // BUCKET)
    order = spatial_order(proxies, BUCKET)
    take = order[torch.arange(nb * BUCKET,
                              device=proxies.device).clamp_(max=n - 1)]
    rows = proxies[take].contiguous()
    lo, hi = torch.aminmax(rows.view(nb, BUCKET, 3), dim=1)
    return ProxyBuckets(proxies, rows, torch.cat([lo, hi], dim=1))


def source_order(points: torch.Tensor) -> torch.Tensor:
    """[ns] int32 order of the source points [ns, 3] for the pruned search:
    `spatial_order` in runs of WARP_POINTS, the points one warp owns.  A
    rotation or translation of the points keeps each run compact, so the
    order of a source serves every rotated copy of it."""
    return spatial_order(points, WARP_POINTS).to(torch.int32)


def _search_args(name, proxies, point_order, ns: int):
    """(points, buckets or None) of a pruned wrapper's proxies argument, a
    tensor or `ProxyBuckets`, with shape, type and device checks of the
    buckets and of point_order ([ns] int32 or None)."""
    buckets = proxies if isinstance(proxies, ProxyBuckets) else None
    points = proxies if buckets is None else buckets.points
    search = {} if buckets is None else dict(rows=buckets.rows,
                                             boxes=buckets.boxes)
    if point_order is not None:
        search["order"] = point_order
    if search:
        check_f32(name, proxies=points, **search)
    nb = -(-points.shape[0] // BUCKET)
    want = {"rows": (nb * BUCKET, 3), "boxes": (nb, 6), "order": (ns,)}
    for key, t in search.items():
        if tuple(t.shape) != want[key]:
            raise ValueError(f"{name}: {key} must be {want[key]}, "
                             f"got {tuple(t.shape)}")
    return points, buckets


def _bisect(x: torch.Tensor, kf: torch.Tensor, mode: str, iters: int,
            points_axis=None):
    """(threshold, lo) of the k-largest bisection over the last axis of x
    (float32, the JAX order: mid = 0.5 * (lo + hi), count(x > mid) >= k).
    Over a sharded points_axis the max and the counts are global (pmax,
    psum), so every shard walks the same bisection."""
    lo = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    hi = torch.amax(torch.clamp(x, min=0.0), dim=-1)
    if sharded(points_axis):
        hi = points_axis.pmax(hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cnt = torch.sum(x > mid[..., None], dim=-1, dtype=torch.float32)
        if sharded(points_axis):
            cnt = points_axis.psum(cnt)
        ge = cnt >= kf
        lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid)
    return (lo if mode == "over" else hi), lo


def dropsum_bracket(x: torch.Tensor, k: int, mode: str,
                    iters: int = BISECT_ITERS,
                    points_axis=None) -> torch.Tensor:
    """Bracket of the sum of the k largest entries of x [..., n] (last axis)
    by threshold bisection, as `fgoicp_tpu/ops/bounds.py::_dropsum_bracket`
    computes it (float32, the same order of operations).

    Entries are weighted squared bound terms (>= 0; -BIG marks masked
    points), so the threshold domain is [0, max].  mode "over" returns a sum
    >= the exact top-k sum (subtracted from a lower bound, it keeps the
    bound sound); "under" returns a sum <= it (for an upper bound).  After
    26 halvings both are exact up to threshold ties.  With x sharded over
    a points_axis (the mesh's points axis, ops/bounds.py), the counts and
    sums are psum'd: the result is the global bracket on every shard."""
    kf = torch.tensor(float(k), dtype=torch.float32, device=x.device)
    t, lo = _bisect(x, kf, mode, iters, points_axis)
    above = x > t[..., None]
    s = torch.sum(torch.where(above, x, 0.0), dim=-1)
    cnt = torch.sum(above, dim=-1, dtype=torch.float32)
    if sharded(points_axis):
        s, cnt = points_axis.psum(s), points_axis.psum(cnt)
    return s + (kf - cnt) * lo


def kept_sum(x: torch.Tensor, k: int, mode: str,
             iters: int = BISECT_ITERS) -> torch.Tensor:
    """sum(x) - dropsum_bracket(x, k, mode) for x >= 0, formed without the
    subtraction of two large sums: with T the bracket's threshold,
        sum(x <= T ? x : 0) - (k - count(x > T)) * lo.
    The drop bracket is never negative for x >= 0, so this equals the JAX
    kernel's total - max(drop, 0) in exact arithmetic; in float32 it keeps
    the trimmed bound's own relative precision where most of the total is
    dropped.  The trimmed lane kernel computes the same expression."""
    kf = torch.tensor(float(k), dtype=torch.float32, device=x.device)
    t, lo = _bisect(x, kf, mode, iters)
    kept = x <= t[..., None]
    s = torch.sum(torch.where(kept, x, 0.0), dim=-1)
    cnt = torch.sum(~kept, dim=-1, dtype=torch.float32)
    return s - (kf - cnt) * lo


def _lane_terms_plain(base, gids, t_lanes, proxies, gam_ub, gam_lb,
                      gam_t_lanes, slack: float, w):
    """Yield (lane slice, ut [c, ns], lt [c, ns]) over lane chunks, with the
    kernels' evaluation order per point."""
    lanes = gids.shape[0]
    ns, n_prox = base.shape[1], proxies.shape[0]
    chunk = max(1, _PLAIN_BLOCK // max(1, ns * n_prox))
    for s in range(0, lanes, chunk):
        g = gids[s:s + chunk].long()
        q = base[g] + t_lanes[s:s + chunk, None, :]             # [c, ns, 3]
        dx = proxies[:, 0] - q[..., 0:1]                        # [c, ns, P]
        dy = proxies[:, 1] - q[..., 1:2]
        dz = proxies[:, 2] - q[..., 2:3]
        m = torch.amin(dx * dx + dy * dy + dz * dz, dim=-1)
        d = torch.sqrt(torch.clamp(torch.clamp(m, max=BIG), min=0.0))
        u = torch.clamp(d - gam_ub[g], min=0.0)
        v = torch.clamp(d - slack - gam_lb[g]
                        - gam_t_lanes[s:s + chunk, None], min=0.0)
        yield slice(s, s + chunk), w * (u * u), w * (v * v)


def fused_bounds_lanes_plain(base, gids, t_lanes, proxies, gam_ub, gam_lb,
                             gam_t_lanes, slack: float, w):
    """Plain torch version of `fused_bounds_lanes`, on any device."""
    lanes = gids.shape[0]
    lb = torch.empty(lanes, dtype=torch.float32, device=base.device)
    ub = torch.empty(lanes, dtype=torch.float32, device=base.device)
    for sl, ut, lt in _lane_terms_plain(base, gids, t_lanes, proxies, gam_ub,
                                        gam_lb, gam_t_lanes, slack, w):
        ub[sl] = torch.sum(ut, dim=-1)
        lb[sl] = torch.sum(lt, dim=-1)
    return lb, ub


def fused_bounds_lanes_trimmed_plain(base, gids, t_lanes, proxies, gam_ub,
                                     gam_lb, gam_t_lanes, slack: float, w,
                                     n_drop: int):
    """Plain torch version of `fused_bounds_lanes_trimmed`, on any device:
    the lane term sums less the "over" (lb) / "under" (ub) bracket of the
    n_drop largest terms, as `kept_sum`."""
    lanes = gids.shape[0]
    lb = torch.empty(lanes, dtype=torch.float32, device=base.device)
    ub = torch.empty(lanes, dtype=torch.float32, device=base.device)
    for sl, ut, lt in _lane_terms_plain(base, gids, t_lanes, proxies, gam_ub,
                                        gam_lb, gam_t_lanes, slack, w):
        ub[sl] = kept_sum(ut, n_drop, "under")
        lb[sl] = kept_sum(lt, n_drop, "over")
    return lb, ub


def fused_bounds_plain(base, t_centers, proxies, gam_ub, gam_lb, gam_t,
                       slack: float, w):
    """Plain torch version of `fused_bounds`, on any device: the [G, B]
    grid as G * B lanes, lane g * B + b in group g."""
    n_groups, n_trans = t_centers.shape[:2]
    gids = torch.arange(n_groups, device=base.device).repeat_interleave(
        n_trans)
    lb, ub = fused_bounds_lanes_plain(
        base, gids, t_centers.reshape(-1, 3), proxies, gam_ub, gam_lb,
        gam_t.reshape(-1), slack, w)
    return lb.reshape(n_groups, n_trans), ub.reshape(n_groups, n_trans)


def _check_args(name, base, proxies, shapes: dict, **tensors):
    """Shape, type, contiguity and device checks of the bound wrappers."""
    if base.ndim != 3 or base.shape[2] != 3:
        raise ValueError(f"{name}: base must be [G, ns, 3], "
                         f"got {tuple(base.shape)}")
    for key, shape in shapes.items():
        if tuple(tensors[key].shape) != shape:
            raise ValueError(f"{name}: {key} must be {shape}, "
                             f"got {tuple(tensors[key].shape)}")
    if proxies.ndim != 2 or proxies.shape[1] != 3 or proxies.shape[0] == 0:
        raise ValueError(f"{name}: proxies must be [P>0, 3], "
                         f"got {tuple(proxies.shape)}")
    return check_f32(name, base=base, proxies=proxies, **tensors)


def _lane_args(name, base, gids, t_lanes, proxies, gam_ub, gam_lb,
               gam_t_lanes, point_weights):
    """Checks of the lane wrappers; returns (device, gam_lb, weights)."""
    if gam_lb is None:
        gam_lb = gam_ub
    n_groups, ns = base.shape[:2]
    lanes = gids.shape[0]
    if point_weights is None:
        point_weights = torch.ones(ns, dtype=torch.float32, device=base.device)
    shapes = {"gids": (lanes,), "t_lanes": (lanes, 3),
              "gam_ub": (n_groups, ns), "gam_lb": (n_groups, ns),
              "gam_t_lanes": (lanes,), "point_weights": (ns,)}
    device = _check_args(
        name, base, proxies, shapes, gids=gids, t_lanes=t_lanes,
        gam_ub=gam_ub, gam_lb=gam_lb, gam_t_lanes=gam_t_lanes,
        point_weights=point_weights)
    return device, gam_lb, point_weights


def _ptr(t):
    return None if t is None else t.data_ptr()


def _request_counts(n_out: int, *tensors):
    """The open request's counter for a launch on tensors[0]'s device
    (None outside a request), after adding the launch's bytes to the
    request's "bound_bytes": each distinct input tensor once, and the lb
    and ub outputs of n_out nodes."""
    inputs = {t.data_ptr(): t for t in tensors if t is not None}
    trace.count("bound_bytes", 8 * n_out + sum(
        t.numel() * t.element_size() for t in inputs.values()))
    return trace.device_counts(tensors[0].device)


def _launch_lanes(base, gids, t_lanes, gam_ub, gam_lb, gam_t_lanes, w,
                  slack: float, buckets: ProxyBuckets, point_order=None,
                  counts=None):
    """The lane kernel on checked CUDA arguments: lb, ub [L].  counts, an
    int64 CUDA tensor [2] or None, gets the (point, proxy) pairs evaluated
    and the (point, box) tests added.  Counts no launch."""
    lib = build.load()
    n_groups, ns = base.shape[:2]
    lanes = gids.shape[0]
    lb = torch.empty(lanes, dtype=torch.float32, device=base.device)
    ub = torch.empty(lanes, dtype=torch.float32, device=base.device)
    with torch.cuda.device(base.device):
        stream = torch.cuda.current_stream(base.device).cuda_stream
        build.check(lib.fgoicp_bounds_lanes(
            base.data_ptr(), gids.data_ptr(), t_lanes.data_ptr(),
            buckets.rows.data_ptr(), buckets.boxes.data_ptr(),
            _ptr(point_order), gam_ub.data_ptr(), gam_lb.data_ptr(),
            gam_t_lanes.data_ptr(), w.data_ptr(), slack, n_groups, ns,
            buckets.boxes.shape[0], lanes, _ptr(counts), lb.data_ptr(),
            ub.data_ptr(), stream), "fused_bounds_lanes")
    return lb, ub


@debug.checked("fused_bounds_lanes", inputs=True)
def fused_bounds_lanes(base, gids, t_lanes, proxies, gam_ub, gam_t_lanes,
                       slack, point_weights=None, gam_lb=None, *,
                       point_order=None):
    """lb, ub [L] for L independent lanes (the pooled-frontier hot op).

    base [G, ns, 3] rotated source per group; gids [L] int32 group per
    lane; t_lanes [L, 3]; proxies [P, 3], or a `ProxyBuckets` of them
    (bucketed here on every CUDA call when a bare tensor); gam_ub / gam_lb
    [G, ns] (gam_lb defaults to gam_ub); gam_t_lanes [L]; slack a Python
    float or 0-d tensor (rounded to float32); point_weights [ns] (default
    ones); point_order [ns] int32, the `source_order` of the source, in
    which the kernel's warps take the points (None: as they come; the
    results are the same, a coherent order prunes more).  Same shapes and
    argument order as the JAX package's function.  Replaces
    `fgoicp_tpu/ops/pallas_bounds.py::fused_bounds_lanes`."""
    proxies, buckets = _search_args("fused_bounds_lanes", proxies,
                                    point_order, base.shape[1])
    device, gam_lb, point_weights = _lane_args(
        "fused_bounds_lanes", base, gids, t_lanes, proxies, gam_ub, gam_lb,
        gam_t_lanes, point_weights)
    slack = float(np.float32(float(slack)))
    if device.type == "cpu":
        return fused_bounds_lanes_plain(base, gids, t_lanes, proxies, gam_ub,
                                        gam_lb, gam_t_lanes, slack,
                                        point_weights)
    if buckets is None:
        buckets = proxy_buckets(proxies)
    counts = _request_counts(
        gids.shape[0], base, gids, t_lanes, buckets.rows, buckets.boxes,
        point_order, gam_ub, gam_lb, gam_t_lanes, point_weights)
    out = _launch_lanes(base, gids, t_lanes, gam_ub, gam_lb, gam_t_lanes,
                        point_weights, slack, buckets, point_order, counts)
    fused_bounds_lanes.launches += 1
    return out


def _launch_lanes_trimmed(base, gids, t_lanes, gam_ub, gam_lb, gam_t_lanes,
                          w, slack: float, n_drop: int,
                          buckets: ProxyBuckets, point_order=None,
                          counts=None):
    """The trimmed lane kernel on checked CUDA arguments: lb, ub [L];
    counts as `_launch_lanes`.  Counts no launch."""
    lib = build.load()
    n_groups, ns = base.shape[:2]
    lanes, n_buckets = gids.shape[0], buckets.boxes.shape[0]
    device = base.device
    lb = torch.empty(lanes, dtype=torch.float32, device=device)
    ub = torch.empty(lanes, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        fits = ctypes.c_int(0)
        build.check(lib.fgoicp_bounds_lanes_trimmed_fits(
            ns, n_buckets, ctypes.byref(fits)), "fused_bounds_lanes_trimmed")
        # Terms that do not fit in shared memory go through a scratch.
        scratch = None if fits.value else torch.empty(
            (lanes, 2, ns), dtype=torch.float32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        build.check(lib.fgoicp_bounds_lanes_trimmed(
            base.data_ptr(), gids.data_ptr(), t_lanes.data_ptr(),
            buckets.rows.data_ptr(), buckets.boxes.data_ptr(),
            _ptr(point_order), gam_ub.data_ptr(), gam_lb.data_ptr(),
            gam_t_lanes.data_ptr(), w.data_ptr(), slack, n_groups, ns,
            n_buckets, lanes, n_drop, _ptr(scratch), _ptr(counts),
            lb.data_ptr(), ub.data_ptr(), stream),
            "fused_bounds_lanes_trimmed")
    return lb, ub


@debug.checked("fused_bounds_lanes_trimmed", inputs=True)
def fused_bounds_lanes_trimmed(base, gids, t_lanes, proxies, gam_ub,
                               gam_t_lanes, slack, n_drop: int,
                               point_weights=None, gam_lb=None, *,
                               point_order=None):
    """Trimmed lb, ub [L]: the lane sums of `fused_bounds_lanes` less a
    sound bracket of each lane's n_drop largest weighted terms ("over" on
    lb, "under" on ub), formed as `kept_sum`.
    point_weights must be a 0/1 mask; proxies and point_order as
    `fused_bounds_lanes`.  Same argument order as the JAX function, plus
    n_drop.  Replaces
    `fgoicp_tpu/ops/pallas_bounds.py::fused_bounds_lanes_trimmed`."""
    proxies, buckets = _search_args("fused_bounds_lanes_trimmed", proxies,
                                    point_order, base.shape[1])
    device, gam_lb, point_weights = _lane_args(
        "fused_bounds_lanes_trimmed", base, gids, t_lanes, proxies, gam_ub,
        gam_lb, gam_t_lanes, point_weights)
    slack = float(np.float32(float(slack)))
    n_drop = int(n_drop)
    if device.type == "cpu":
        return fused_bounds_lanes_trimmed_plain(
            base, gids, t_lanes, proxies, gam_ub, gam_lb, gam_t_lanes, slack,
            point_weights, n_drop)
    if buckets is None:
        buckets = proxy_buckets(proxies)
    counts = _request_counts(
        gids.shape[0], base, gids, t_lanes, buckets.rows, buckets.boxes,
        point_order, gam_ub, gam_lb, gam_t_lanes, point_weights)
    out = _launch_lanes_trimmed(base, gids, t_lanes, gam_ub, gam_lb,
                                gam_t_lanes, point_weights, slack, n_drop,
                                buckets, point_order, counts)
    fused_bounds_lanes_trimmed.launches += 1
    return out


def _launch_grid(base, t_centers, gam_ub, gam_lb, gam_t, w, slack: float,
                 buckets: ProxyBuckets, point_order=None, counts=None):
    """The grid kernel on checked CUDA arguments: lb, ub [G, B]; counts as
    `_launch_lanes`.  Counts no launch."""
    lib = build.load()
    n_groups, ns = base.shape[:2]
    n_trans = t_centers.shape[1]
    lb = torch.empty((n_groups, n_trans), dtype=torch.float32,
                     device=base.device)
    ub = torch.empty((n_groups, n_trans), dtype=torch.float32,
                     device=base.device)
    with torch.cuda.device(base.device):
        stream = torch.cuda.current_stream(base.device).cuda_stream
        build.check(lib.fgoicp_bounds_grid(
            base.data_ptr(), t_centers.data_ptr(), buckets.rows.data_ptr(),
            buckets.boxes.data_ptr(), _ptr(point_order),
            gam_ub.data_ptr(), gam_lb.data_ptr(), gam_t.data_ptr(),
            w.data_ptr(), slack, n_groups, n_trans, ns,
            buckets.boxes.shape[0], _ptr(counts), lb.data_ptr(),
            ub.data_ptr(), stream), "fused_bounds")
    return lb, ub


@debug.checked("fused_bounds", inputs=True)
def fused_bounds(base, t_centers, proxies, gam_ub, gam_t, slack,
                 point_weights=None, gam_lb=None, *, point_order=None):
    """lb, ub [G, B] for the grid of nodes (group g, translation
    t_centers[g, b]).

    base [G, ns, 3]; t_centers [G, B, 3]; proxies [P, 3] or a
    `ProxyBuckets`; gam_ub / gam_lb [G, ns] (gam_lb defaults to gam_ub);
    gam_t [G, B]; slack a float; point_weights [ns] (default ones);
    proxies and point_order as `fused_bounds_lanes`.  Same argument order
    as the JAX function.  Replaces
    `fgoicp_tpu/ops/pallas_bounds.py::fused_bounds`."""
    if gam_lb is None:
        gam_lb = gam_ub
    if t_centers.ndim != 3 or t_centers.shape[2] != 3:
        raise ValueError(f"fused_bounds: t_centers must be [G, B, 3], "
                         f"got {tuple(t_centers.shape)}")
    n_groups, ns = base.shape[:2]
    n_trans = t_centers.shape[1]
    proxies, buckets = _search_args("fused_bounds", proxies, point_order, ns)
    if point_weights is None:
        point_weights = torch.ones(ns, dtype=torch.float32, device=base.device)
    shapes = {"t_centers": (n_groups, n_trans, 3), "gam_ub": (n_groups, ns),
              "gam_lb": (n_groups, ns), "gam_t": (n_groups, n_trans),
              "point_weights": (ns,)}
    device = _check_args(
        "fused_bounds", base, proxies, shapes, t_centers=t_centers,
        gam_ub=gam_ub, gam_lb=gam_lb, gam_t=gam_t,
        point_weights=point_weights)
    slack = float(np.float32(float(slack)))
    if device.type == "cpu":
        return fused_bounds_plain(base, t_centers, proxies, gam_ub, gam_lb,
                                  gam_t, slack, point_weights)
    if buckets is None:
        buckets = proxy_buckets(proxies)
    counts = _request_counts(
        n_groups * n_trans, base, t_centers, buckets.rows, buckets.boxes,
        point_order, gam_ub, gam_lb, gam_t, point_weights)
    out = _launch_grid(base, t_centers, gam_ub, gam_lb, gam_t, point_weights,
                       slack, buckets, point_order, counts)
    fused_bounds.launches += 1
    return out


fused_bounds_lanes.launches = 0
fused_bounds_lanes_trimmed.launches = 0
fused_bounds.launches = 0
