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
The kernels compute the terms bit for bit as the plain versions do; only
the order of the final sums over i differs, hence the rtol 2e-4 /
atol 2e-5 they are compared at (the JAX package's tolerance between its
Pallas kernels and XLA path).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..kernels import build
from .cuda_nn import BIG, check_f32

# Elements of one [lanes, ns, P] distance block in the plain versions.
_PLAIN_BLOCK = 1 << 24
BISECT_ITERS = 26


def _bisect(x: torch.Tensor, kf: torch.Tensor, mode: str, iters: int):
    """(threshold, lo) of the k-largest bisection over the last axis of x
    (float32, the JAX order: mid = 0.5 * (lo + hi), count(x > mid) >= k)."""
    lo = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    hi = torch.amax(torch.clamp(x, min=0.0), dim=-1)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cnt = torch.sum(x > mid[..., None], dim=-1, dtype=torch.float32)
        ge = cnt >= kf
        lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid)
    return (lo if mode == "over" else hi), lo


def dropsum_bracket(x: torch.Tensor, k: int, mode: str,
                    iters: int = BISECT_ITERS) -> torch.Tensor:
    """Bracket of the sum of the k largest entries of x [..., n] (last axis)
    by threshold bisection, as `fgoicp_tpu/ops/bounds.py::_dropsum_bracket`
    computes it (float32, the same order of operations).

    Entries are weighted squared bound terms (>= 0; -BIG marks masked
    points), so the threshold domain is [0, max].  mode "over" returns a sum
    >= the exact top-k sum (subtracted from a lower bound, it keeps the
    bound sound); "under" returns a sum <= it (for an upper bound).  After
    26 halvings both are exact up to threshold ties."""
    kf = torch.tensor(float(k), dtype=torch.float32, device=x.device)
    t, lo = _bisect(x, kf, mode, iters)
    above = x > t[..., None]
    s = torch.sum(torch.where(above, x, 0.0), dim=-1)
    cnt = torch.sum(above, dim=-1, dtype=torch.float32)
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


def fused_bounds_lanes(base, gids, t_lanes, proxies, gam_ub, gam_t_lanes,
                       slack, point_weights=None, gam_lb=None):
    """lb, ub [L] for L independent lanes (the pooled-frontier hot op).

    base [G, ns, 3] rotated source per group; gids [L] int32 group per
    lane; t_lanes [L, 3]; proxies [P, 3]; gam_ub / gam_lb [G, ns]
    (gam_lb defaults to gam_ub); gam_t_lanes [L]; slack a Python float or
    0-d tensor (rounded to float32); point_weights [ns] (default ones).
    Same layout and argument order as the JAX package's function.
    Replaces `fgoicp_tpu/ops/pallas_bounds.py::fused_bounds_lanes`."""
    device, gam_lb, point_weights = _lane_args(
        "fused_bounds_lanes", base, gids, t_lanes, proxies, gam_ub, gam_lb,
        gam_t_lanes, point_weights)
    slack = float(np.float32(float(slack)))
    if device.type == "cpu":
        return fused_bounds_lanes_plain(base, gids, t_lanes, proxies, gam_ub,
                                        gam_lb, gam_t_lanes, slack,
                                        point_weights)
    lib = build.load()
    n_groups, ns = base.shape[:2]
    lanes = gids.shape[0]
    lb = torch.empty(lanes, dtype=torch.float32, device=device)
    ub = torch.empty(lanes, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        build.check(lib.fgoicp_bounds_lanes(
            base.data_ptr(), gids.data_ptr(), t_lanes.data_ptr(),
            proxies.data_ptr(), gam_ub.data_ptr(), gam_lb.data_ptr(),
            gam_t_lanes.data_ptr(), point_weights.data_ptr(), slack,
            n_groups, ns, proxies.shape[0], lanes, lb.data_ptr(),
            ub.data_ptr(), stream), "fused_bounds_lanes")
    fused_bounds_lanes.launches += 1
    return lb, ub


def fused_bounds_lanes_trimmed(base, gids, t_lanes, proxies, gam_ub,
                               gam_t_lanes, slack, n_drop: int,
                               point_weights=None, gam_lb=None):
    """Trimmed lb, ub [L]: the lane sums of `fused_bounds_lanes` less a
    sound bracket of each lane's n_drop largest weighted terms ("over" on
    lb, "under" on ub), formed as `kept_sum`.
    point_weights must be a 0/1 mask.  Same argument order as the JAX
    function, plus n_drop.  Replaces
    `fgoicp_tpu/ops/pallas_bounds.py::fused_bounds_lanes_trimmed`."""
    device, gam_lb, point_weights = _lane_args(
        "fused_bounds_lanes_trimmed", base, gids, t_lanes, proxies, gam_ub,
        gam_lb, gam_t_lanes, point_weights)
    slack = float(np.float32(float(slack)))
    n_drop = int(n_drop)
    if device.type == "cpu":
        return fused_bounds_lanes_trimmed_plain(
            base, gids, t_lanes, proxies, gam_ub, gam_lb, gam_t_lanes, slack,
            point_weights, n_drop)
    lib = build.load()
    n_groups, ns = base.shape[:2]
    lanes, n_prox = gids.shape[0], proxies.shape[0]
    lb = torch.empty(lanes, dtype=torch.float32, device=device)
    ub = torch.empty(lanes, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        fits = ctypes.c_int(0)
        build.check(lib.fgoicp_bounds_lanes_trimmed_fits(
            ns, n_prox, ctypes.byref(fits)), "fused_bounds_lanes_trimmed")
        # Terms that do not fit in shared memory go through a scratch.
        scratch = None if fits.value else torch.empty(
            (lanes, 2, ns), dtype=torch.float32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        build.check(lib.fgoicp_bounds_lanes_trimmed(
            base.data_ptr(), gids.data_ptr(), t_lanes.data_ptr(),
            proxies.data_ptr(), gam_ub.data_ptr(), gam_lb.data_ptr(),
            gam_t_lanes.data_ptr(), point_weights.data_ptr(), slack,
            n_groups, ns, n_prox, lanes, n_drop,
            None if scratch is None else scratch.data_ptr(), lb.data_ptr(),
            ub.data_ptr(), stream), "fused_bounds_lanes_trimmed")
    fused_bounds_lanes_trimmed.launches += 1
    return lb, ub


def fused_bounds(base, t_centers, proxies, gam_ub, gam_t, slack,
                 point_weights=None, gam_lb=None):
    """lb, ub [G, B] for the grid of nodes (group g, translation
    t_centers[g, b]).

    base [G, ns, 3]; t_centers [G, B, 3]; proxies [P, 3]; gam_ub / gam_lb
    [G, ns] (gam_lb defaults to gam_ub); gam_t [G, B]; slack a float;
    point_weights [ns] (default ones).  Same argument order as the JAX
    function.  Replaces `fgoicp_tpu/ops/pallas_bounds.py::fused_bounds`."""
    if gam_lb is None:
        gam_lb = gam_ub
    if t_centers.ndim != 3 or t_centers.shape[2] != 3:
        raise ValueError(f"fused_bounds: t_centers must be [G, B, 3], "
                         f"got {tuple(t_centers.shape)}")
    n_groups, ns = base.shape[:2]
    n_trans = t_centers.shape[1]
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
    lib = build.load()
    lb = torch.empty((n_groups, n_trans), dtype=torch.float32, device=device)
    ub = torch.empty((n_groups, n_trans), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        build.check(lib.fgoicp_bounds_grid(
            base.data_ptr(), t_centers.data_ptr(), proxies.data_ptr(),
            gam_ub.data_ptr(), gam_lb.data_ptr(), gam_t.data_ptr(),
            point_weights.data_ptr(), slack, n_groups, n_trans, ns,
            proxies.shape[0], lb.data_ptr(), ub.data_ptr(), stream),
            "fused_bounds")
    fused_bounds.launches += 1
    return lb, ub


fused_bounds_lanes.launches = 0
fused_bounds_lanes_trimmed.launches = 0
fused_bounds.launches = 0
