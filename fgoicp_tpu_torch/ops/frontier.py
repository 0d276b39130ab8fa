"""Grouped inner R^3 BnB: G independent per-group frontiers in lockstep.

Counterpart of `fgoicp_tpu/ops/frontier.py::bnb_r3_batched` on one device
(`frontier_mode="grouped"`).  Each of the G searches (one per rotation
candidate) keeps a fixed-capacity frontier of translation nodes sorted by
lower bound; every step pops the best B nodes of every group, evaluates
the [G, B] grid in one call (ops/bounds.py::evaluate_bounds: for a proxy
backend the fused grid kernel when untrimmed, the nearest-proxy kernel and
the trimmed reductions otherwise; for a LUT backend the field lookups and
the torch reductions), updates per-group incumbents, expands octree children and
merges them back.  The JAX `lax.while_loop` is a Python loop whose
condition is read on the host once per step.

Semantics per group, as the reference's branch_and_bound_R3
(fgoicp.cpp:102-174): root (0,0,0) with half-span 1; termination when
best_error - min_lb < sse_threshold or the frontier is empty; nodes with
lb >= best_error are discarded; children inherit the parent's lb; nodes
below min_span are not split.

The sort is `torch.argsort(stable=True)`: the 8 children of a node share
their parent's lb, and `jnp.argsort` is stable.  A full frontier drops its
worst-lb nodes (counted in `dropped`); the minimum dropped lb per group is
kept in `dropped_lb`, and a max_steps exit folds the surviving frontier
minimum of still-active groups into it, so the consumer's clamp
(models/goicp.py) keeps the lower bound sound on every exit path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import bounds as bounds_ops
from . import geometry as geo

INVALID = 1e30
BIG = 1e10  # reference M_INF


class R3State(NamedTuple):
    centers: torch.Tensor     # [G, C, 3]
    spans: torch.Tensor       # [G, C]
    lbs: torch.Tensor         # [G, C] (INVALID marks an empty slot)
    best_err: torch.Tensor    # [G] incumbent error for pruning
    best_ub: torch.Tensor     # [G] min upper bound seen
    best_t: torch.Tensor      # [G, 3]
    active: torch.Tensor      # [G] bool
    steps: int                # host loop counter
    evaluated: torch.Tensor   # [G] int64 nodes evaluated (ref: count)
    dropped: torch.Tensor     # [G] int64 children lost to capacity
    dropped_lb: torch.Tensor  # [G] min lb ever dropped (INVALID = none)


def _sort_frontier(centers, spans, lbs, capacity: int):
    """Sort candidates [G, N] ascending by lb (stable) and keep the best
    `capacity`.  Also returns, per group, the count of valid nodes dropped
    and the minimum lb among the dropped ones (INVALID when none)."""
    order = torch.argsort(lbs, dim=-1, stable=True)
    take = order[:, :capacity]
    lbs_s = torch.take_along_dim(lbs, take, dim=-1)
    spans_s = torch.take_along_dim(spans, take, dim=-1)
    centers_s = torch.take_along_dim(centers, take[..., None], dim=-2)
    n_valid = torch.sum(lbs < INVALID, dim=-1)
    dropped = torch.clamp(n_valid - capacity, min=0)
    rest_lb = torch.take_along_dim(lbs, order[:, capacity:], dim=-1)
    drop_min = torch.amin(rest_lb, dim=-1)
    return centers_s, spans_s, lbs_s, dropped, drop_min


def bnb_r3_batched(backend: bounds_ops.Backend, pcs: torch.Tensor,
                   R: torch.Tensor, rot_spans: torch.Tensor,
                   fix_rot: torch.Tensor, best_sse: float,
                   sse_threshold: float, group_active=None,
                   min_span: float = 0.1, batch: int = 32,
                   capacity: int = 4096, max_steps: int = 100000,
                   ref_compat_gamma: bool = False,
                   trim_keep: Optional[int] = None, points_axis=None,
                   lockstep_axes=(), point_weights=None,
                   trim_ns: Optional[int] = None,
                   point_order=None) -> R3State:
    """Run G translation BnB searches in lockstep.

    pcs [ns, 3] source; R [G, 3, 3]; rot_spans [G]; fix_rot [G] bool
    (True = gamma_r off); best_sse / sse_threshold Python floats;
    group_active [G] bool; point_order the grid kernel's
    `cuda_bounds.source_order` of pcs.  Returns the final R3State."""
    if points_axis is not None or lockstep_axes:
        raise NotImplementedError(
            "sharded grouped BnB (points_axis / lockstep_axes) is ROADMAP "
            "Queue 1 item 16 (multi-GPU)")
    dev = pcs.device
    g = R.shape[0]
    if group_active is None:
        group_active = torch.ones(g, dtype=torch.bool, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    spans0 = torch.zeros((g, capacity), **f32)
    spans0[:, 0] = 1.0
    lbs0 = torch.full((g, capacity), INVALID, **f32)
    lbs0[:, 0] = 0.0
    s = R3State(
        centers=torch.zeros((g, capacity, 3), **f32), spans=spans0, lbs=lbs0,
        best_err=torch.full((g,), float(best_sse), **f32),
        best_ub=torch.full((g,), BIG, **f32),
        best_t=torch.zeros((g, 3), **f32),
        active=group_active.clone(), steps=0,
        evaluated=torch.zeros(g, dtype=torch.int64, device=dev),
        dropped=torch.zeros(g, dtype=torch.int64, device=dev),
        dropped_lb=torch.full((g,), INVALID, **f32))
    b = batch

    while s.steps < max_steps and bool(torch.any(s.active)):
        # Discard dominated nodes (ref pops-and-drops them, fgoicp.cpp:127).
        lbs = torch.where(s.lbs < s.best_err[:, None], s.lbs, INVALID)
        top_lb = lbs[:, 0]
        empty = top_lb >= INVALID
        converged = (s.best_err - top_lb) < sse_threshold   # fgoicp.cpp:120
        active = s.active & ~(empty | converged)

        # Pop the best B nodes per group (the frontier is sorted).
        cand_c = s.centers[:, :b]
        cand_s = s.spans[:, :b]
        lane_valid = (lbs[:, :b] < INVALID) & active[:, None]
        lb_e, ub_e = bounds_ops.evaluate_bounds(
            backend, pcs, R, rot_spans, fix_rot, cand_c, cand_s,
            node_mask=lane_valid, ref_compat_gamma=ref_compat_gamma,
            trim_keep=trim_keep, point_weights=point_weights,
            trim_ns=trim_ns, point_order=point_order)

        # Incumbent update from the batch min ub (fgoicp.cpp:139-145).
        batch_min, batch_arg = torch.min(ub_e, dim=-1)          # first index
        best_ub = torch.where(active, torch.minimum(s.best_ub, batch_min),
                              s.best_ub)
        improve = active & (batch_min < s.best_err)
        best_err = torch.where(improve, batch_min, s.best_err)
        best_t = torch.where(
            improve[:, None],
            torch.take_along_dim(cand_c, batch_arg[:, None, None], dim=1)[:, 0],
            s.best_t)

        # Children of surviving, still-splittable nodes (fgoicp.cpp:148-169).
        split = lane_valid & (lb_e < best_err[:, None]) & (cand_s >= min_span)
        ch_c, ch_s = geo.split_octree(cand_c, cand_s)           # [G, B, 8, 3]
        ch_lb = torch.where(split, lb_e, INVALID)[:, :, None].expand(g, b, 8)

        # Merge: remaining frontier + children, re-sort, truncate.
        all_c = torch.cat([s.centers[:, b:], ch_c.reshape(g, b * 8, 3)], dim=1)
        all_s = torch.cat([s.spans[:, b:], ch_s.reshape(g, b * 8)], dim=1)
        all_lb = torch.cat([lbs[:, b:], ch_lb.reshape(g, b * 8)], dim=1)
        new_c, new_s, new_lb, drop, drop_min = _sort_frontier(
            all_c, all_s, all_lb, capacity)
        dropped_lb = torch.minimum(
            s.dropped_lb, torch.where(active, drop_min, INVALID))

        # Freeze inactive groups.
        keep = ~active
        s = R3State(
            centers=torch.where(keep[:, None, None], s.centers, new_c),
            spans=torch.where(keep[:, None], s.spans, new_s),
            lbs=torch.where(keep[:, None], s.lbs, new_lb),
            best_err=best_err, best_ub=best_ub, best_t=best_t,
            active=active, steps=s.steps + 1,
            evaluated=s.evaluated + torch.sum(lane_valid, dim=-1),
            dropped=s.dropped + torch.where(active, drop, 0),
            dropped_lb=dropped_lb)

    # A max_steps exit: fold the surviving frontier minimum of still-active
    # groups into dropped_lb (their subtrees were never explored).
    return s._replace(dropped_lb=torch.where(
        s.active, torch.minimum(s.dropped_lb, s.lbs[:, 0]), s.dropped_lb))
