"""Pooled inner R^3 BnB: one global frontier shared by all groups.

Counterpart of `fgoicp_tpu/ops/pool_frontier.py::bnb_r3_pooled` with
`pool_update="sort"`, on one device.  One pool of (group id, center, span,
lb) nodes sorted by lower bound:

  each step:
    pop the globally best L nodes (any group) ->
    evaluate all L lanes (`_eval_lanes`) ->
    per-group incumbent updates via one-hot reductions ->
    split survivors into octree children, filter dominated nodes,
    stable-sort, truncate to capacity.

Lane evaluation with a proxy backend, on the card by CUDA kernels and on
the CPU by their plain torch versions (ops/cuda_bounds.py):
  - untrimmed: `fused_bounds_lanes`;
  - trimmed plain sources (n_drop = trim_ns - trim_keep > 0):
    `fused_bounds_lanes_trimmed`, which keeps the lanes' [L, ns] term
    tensors out of device memory.  The JAX package leaves this kernel
    opt-in on the TPU on the strength of a TPU measurement; on the card it
    is the path (its times against the unfused path are in PERF.md);
  - trimmed source clusters (point_deltas given): the nearest-proxy kernel
    and the member-level clustered trim of ops/bounds.py, as the JAX
    package's XLA lane path computes them.
With a LUT backend every lane goes through the field lookups
(`bounds.point_terms`) and the torch reductions — untrimmed, trimmed with
the bisection brackets, or the clustered trim — as the JAX package's XLA
lane path (`_eval_lanes_xla`) does; no proxy lane kernel is launched.

The JAX `lax.while_loop` is a Python loop whose condition is read on the
host once per step.  The sort is `torch.argsort(stable=True)`: the 8
children of a node share their parent's lb, and `jnp.argsort` is stable, so
an unstable sort would change the pool order and the node counts.

Pool overflow and the certificate: when valid nodes exceed `capacity`, the
worst-lb nodes are dropped (counted in `dropped`) and the per-group minimum
dropped lb is kept in `dropped_lb` ([G], INVALID when none); the consumer
must clamp its lower bound with it (models/goicp.py does).  A max_steps exit
folds the surviving frontier minimum of still-active groups into
`dropped_lb` the same way.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import bounds as bounds_ops
from . import cuda_bounds
from . import geometry as geo

INVALID = 1e30
BIG = 1e10


class PoolState(NamedTuple):
    lbs: torch.Tensor        # [CP] (INVALID marks empty slots)
    gids: torch.Tensor       # [CP] int64
    centers: torch.Tensor    # [CP, 3]
    spans: torch.Tensor      # [CP]
    best_err: torch.Tensor   # [G] per-group pruning incumbent
    best_ub: torch.Tensor    # [G] min upper bound seen
    best_t: torch.Tensor     # [G, 3]
    active: torch.Tensor     # [G] bool
    steps: int               # host loop counter
    evaluated: torch.Tensor  # [G] int64
    dropped: torch.Tensor    # 0-d int64 (pool-overflow losses)
    dropped_lb: torch.Tensor  # [G] min lb ever dropped (INVALID = none)


def _group_min(values: torch.Tensor, gids: torch.Tensor, g: int):
    """Per-group minimum of values [N] ([G], INVALID for empty groups)."""
    out = torch.full((g,), INVALID, dtype=torch.float32, device=values.device)
    return out.scatter_reduce_(0, gids, values, reduce="amin")


def bnb_r3_pooled(backend: bounds_ops.Backend, pcs: torch.Tensor,
                  R: torch.Tensor, rot_spans: torch.Tensor,
                  fix_rot: torch.Tensor, best_sse: float,
                  sse_threshold: float, group_active=None,
                  min_span: float = 0.1, lanes: int = 1024,
                  capacity: int = 32768, max_steps: int = 100000,
                  ref_compat_gamma: bool = False,
                  trim_keep: Optional[int] = None,
                  point_weights=None, point_deltas=None,
                  err_share_from=None, pool_update: str = "sort",
                  trim_ns: Optional[int] = None, point_order=None,
                  **unported) -> PoolState:
    """Pool-scheduled inner BnB for G rotation groups.

    pcs [ns, 3] (search source points or cluster representatives),
    R [G, 3, 3], rot_spans [G], fix_rot [G] bool, group_active [G] bool;
    best_sse / sse_threshold Python floats.  point_weights / point_deltas
    [ns]: source-cluster multiplicities and radii.  err_share_from [G]
    int: group whose incumbent validly upper-bounds this group's objective
    (-1 = none) — the engine points each gamma-relaxed lb-pass group at its
    fixed-rotation twin.  trim_keep / trim_ns: keep the trim_keep smallest
    of trim_ns member terms (trim_ns defaults to ns; with point_deltas it
    is the global member count).  point_order: the proxy lane kernels'
    `cuda_bounds.source_order` of pcs.  Returns the final PoolState.
    """
    if unported:
        raise NotImplementedError(
            f"bnb_r3_pooled options {sorted(unported)}: point sharding and "
            f"lockstep axes are ROADMAP Queue 1 item 16 (multi-GPU)")
    if pool_update == "merge":
        raise NotImplementedError(
            "pool_update='merge' is not ported (ROADMAP Queue 1 item 7 "
            "ports 'sort' only)")
    if pool_update != "sort":
        raise ValueError(f"Unknown pool_update mode: {pool_update!r}")
    lut = isinstance(backend, bounds_ops.LutBackend)
    if not lut and not isinstance(backend, bounds_ops.ProxyBackend):
        raise TypeError(f"Unknown backend type: {type(backend)}")
    dev = pcs.device
    g = R.shape[0]
    if capacity < g:
        raise ValueError(
            f"pool capacity {capacity} < {g} groups: root nodes would be "
            f"dropped and their searches would never terminate")
    if group_active is None:
        group_active = torch.ones(g, dtype=torch.bool, device=dev)
    clustered_trim = trim_keep is not None and point_deltas is not None
    if clustered_trim and (point_weights is None or trim_ns is None):
        raise ValueError(
            "clustered trimming needs point_weights (member counts) and "
            "trim_ns (global member count)")
    n_drop = 0
    if trim_keep is not None:
        n_drop = (trim_ns if trim_ns is not None else pcs.shape[0]) \
            - trim_keep

    base = torch.einsum("grc,nc->gnr", R, pcs).contiguous()     # [G, ns, 3]
    norms = torch.linalg.vector_norm(pcs, dim=-1)
    gam_ub, gam_lb = bounds_ops.gamma_arrays(
        norms, rot_spans, fix_rot, ref_compat=ref_compat_gamma,
        point_deltas=point_deltas)                               # [G, ns] x2
    gam_ub, gam_lb = gam_ub.contiguous(), gam_lb.contiguous()
    if point_weights is not None:
        point_weights = point_weights.contiguous()
    if not lut:
        # One read-back per call; the kernel takes the slack as a float32.
        slack = float(backend.coreset.eps)
    share = None
    if err_share_from is not None:
        share = torch.as_tensor(err_share_from, device=dev).long()

    cp = capacity
    gid0 = torch.arange(cp, device=dev) % g
    in_init = torch.arange(cp, device=dev) < g
    f32 = dict(dtype=torch.float32, device=dev)
    s = PoolState(
        lbs=torch.where(in_init & group_active[gid0],
                        torch.zeros((), **f32), torch.full((), INVALID, **f32)),
        gids=gid0,
        centers=torch.zeros((cp, 3), **f32),
        spans=torch.where(in_init, 1.0, 0.0).to(torch.float32),
        best_err=torch.full((g,), float(best_sse), **f32),
        best_ub=torch.full((g,), BIG, **f32),
        best_t=torch.zeros((g, 3), **f32),
        active=group_active.clone(),
        steps=0,
        evaluated=torch.zeros(g, dtype=torch.int64, device=dev),
        dropped=torch.zeros((), dtype=torch.int64, device=dev),
        dropped_lb=torch.full((g,), INVALID, **f32),
    )
    grange = torch.arange(g, device=dev)

    while s.steps < max_steps and bool(torch.any(s.active)):
        pop_lb = s.lbs[:lanes]
        pop_gid = s.gids[:lanes]
        pop_c = s.centers[:lanes]
        pop_s = s.spans[:lanes]
        nl = pop_lb.shape[0]
        lane_valid = ((pop_lb < INVALID) & (pop_lb < s.best_err[pop_gid])
                      & s.active[pop_gid])
        gam_t_l = geo.translation_uncertainty_radius(pop_s)
        if lut or clustered_trim:
            lb_pt, ub_pt = bounds_ops.point_terms(
                backend, base[pop_gid] + pop_c[:, None, :],
                gam_ub[pop_gid], gam_lb[pop_gid], gam_t_l)
            if clustered_trim:
                lb_e, ub_e = bounds_ops.reduce_clustered_trimmed(
                    lb_pt, ub_pt, point_weights, trim_keep, trim_ns)
            else:
                lb_e = bounds_ops.reduce_point_terms(
                    lb_pt, point_weights, trim_keep, trim_ns=trim_ns,
                    drop_mode="over")
                ub_e = bounds_ops.reduce_point_terms(
                    ub_pt, point_weights, trim_keep, trim_ns=trim_ns,
                    drop_mode="under")
        elif n_drop > 0:
            lb_e, ub_e = cuda_bounds.fused_bounds_lanes_trimmed(
                base, pop_gid.to(torch.int32), pop_c.contiguous(),
                backend.buckets, gam_ub, gam_t_l.contiguous(), slack, n_drop,
                point_weights=point_weights, gam_lb=gam_lb,
                point_order=point_order)
        else:
            lb_e, ub_e = cuda_bounds.fused_bounds_lanes(
                base, pop_gid.to(torch.int32), pop_c.contiguous(),
                backend.buckets, gam_ub, gam_t_l.contiguous(), slack,
                point_weights=point_weights, gam_lb=gam_lb,
                point_order=point_order)
        lb_e = torch.where(lane_valid, lb_e, BIG)
        ub_e = torch.where(lane_valid, ub_e, BIG)

        # Per-group incumbent updates via one-hot reductions [L, G].
        onehot = pop_gid[:, None] == grange[None, :]
        ub_grid = torch.where(onehot, ub_e[:, None], BIG)
        grp_min_ub, grp_arg = torch.min(ub_grid, dim=0)         # first lane
        best_ub = torch.where(s.active, torch.minimum(s.best_ub, grp_min_ub),
                              s.best_ub)
        improve = s.active & (grp_min_ub < s.best_err)
        best_err = torch.where(improve, grp_min_ub, s.best_err)
        best_t = torch.where(improve[:, None], pop_c[grp_arg], s.best_t)
        if share is not None:
            donor = best_err[torch.clamp(share, min=0)]
            best_err = torch.where(share >= 0, torch.minimum(best_err, donor),
                                   best_err)

        # Children inherit the evaluated lb (fgoicp.cpp:159-166).
        split = lane_valid & (lb_e < best_err[pop_gid]) & (pop_s >= min_span)
        ch_c, ch_s = geo.split_octree(pop_c, pop_s)             # [L, 8, 3]
        ch_lb = torch.where(split, lb_e, INVALID)[:, None].expand(nl, 8)
        ch_gid = pop_gid[:, None].expand(nl, 8)

        all_lb = torch.cat([s.lbs[lanes:], ch_lb.reshape(-1)])
        all_gid = torch.cat([s.gids[lanes:], ch_gid.reshape(-1)])
        all_c = torch.cat([s.centers[lanes:], ch_c.reshape(-1, 3)])
        all_s = torch.cat([s.spans[lanes:], ch_s.reshape(-1)])
        # Re-check dominance against the fresher incumbent and inactive
        # groups before sorting (ref pops-and-drops, fgoicp.cpp:127).
        keep = ((all_lb < INVALID) & (all_lb < best_err[all_gid])
                & s.active[all_gid])
        all_lb = torch.where(keep, all_lb, INVALID)
        order = torch.argsort(all_lb, stable=True)
        head, rest = order[:cp], order[cp:]
        n_valid = torch.sum(keep)
        dropped = s.dropped + torch.clamp(n_valid - cp, min=0)
        # Certificate soundness under overflow: the per-group minimum lb
        # among dropped (still-valid) nodes clamps the group's lb later.
        dropped_lb = torch.minimum(
            s.dropped_lb, _group_min(all_lb[rest], all_gid[rest], g))
        new_lb, new_gid = all_lb[head], all_gid[head]

        minlb = _group_min(new_lb, new_gid, g)
        converged = (best_err - minlb) < sse_threshold
        empty = minlb >= INVALID
        evaluated = s.evaluated + torch.sum(
            onehot & lane_valid[:, None], dim=0)
        s = PoolState(
            lbs=new_lb, gids=new_gid, centers=all_c[head], spans=all_s[head],
            best_err=best_err, best_ub=best_ub, best_t=best_t,
            active=s.active & ~(converged | empty), steps=s.steps + 1,
            evaluated=evaluated, dropped=dropped, dropped_lb=dropped_lb)

    # A max_steps exit leaves still-active groups with unexplored frontier
    # nodes whose lb can sit below the group's returned result; fold the
    # surviving per-group frontier minimum into dropped_lb so the consumer's
    # clamp stays a sound lower bound on every exit path.
    exit_minlb = _group_min(s.lbs, s.gids, g)
    return s._replace(dropped_lb=torch.where(
        s.active, torch.minimum(s.dropped_lb, exit_minlb), s.dropped_lb))
