"""Pooled inner R^3 BnB: one global frontier shared by all groups.

Counterpart of `fgoicp_tpu/ops/pool_frontier.py::bnb_r3_pooled`.  One
pool of (group id, center, span, lb) nodes sorted by lower bound:

  each step:
    pop the globally best L nodes (any group) ->
    evaluate all L lanes ->
    per-group incumbent updates via one-hot reductions ->
    split survivors into octree children, then by `pool_update`:
      "sort" (default): filter dominated nodes, stable-sort, truncate;
      "merge": the pool stays sorted by invariant (one sort at init);
        sort the L parents' keys (stable: the 8 children share their
        parent's lb), repeat them 8-fold and merge that run into the pool
        suffix by two binary searches (`_merge_sorted`, the pool first on
        ties); dominated and inactive-group nodes stay until popped, where
        the lane mask drops them, or until truncated off the tail.
    Merge is near-exact against sort: a dominated node of one group can
    sort ahead of a live one of another and waste its lane, so steps can
    differ by a few; the optima, the certificate and dropped_lb do not.

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

On a mesh (parallel/bnb.py) the pool is this rank's cube shard of the
groups, and pcs this rank's shard of the points:
  - the loop runs while any group of any rank is live: the live count is
    psum'd over `lockstep_axes` and `points_axis` every step, so a shard
    whose pool drained keeps joining the collectives of the others;
  - the lanes' lb and ub are psum'd over `points_axis`;
  - twin sharing across cube shards all-gathers best_err over
    `err_share_axis` (err_share_from then holds global group ids).
Point-sharded trimming takes the per-point path (the nearest-proxy
`nn_min` kernel, then the bracket on global counts), as the JAX package
does: the trimmed lane kernel drops the largest terms of its own points,
and no lane kernel can drop across shards.

The JAX `lax.while_loop` is a Python loop whose condition is read on the
host once per step.  Every sort is `torch.argsort(stable=True)`: the 8
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
from ..parallel.sharding import any_live, sharded
from ..utils import trace

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


def _count_less(a: torch.Tensor, v: torch.Tensor, strict: bool):
    """The number of entries of sorted `a` [n] below v (strict) or at most
    v, per query v [m]: JAX's binary search (`_count_less`) as
    `torch.searchsorted` (right=False counts a < v, right=True a <= v)."""
    return torch.searchsorted(a, v, right=not strict)


def _merge_sorted(a_lb, b_lb, a_payload, b_payload):
    """Stable merge of two lb-sorted runs, a first on ties: (lb [Na+Nb],
    [payload [Na+Nb, ...] for each pair of payloads]).  Each element's
    place is its index in its run plus the count of the other run's
    elements that go before it; the places form one permutation."""
    na, nb = a_lb.shape[0], b_lb.shape[0]
    dev = a_lb.device
    pos_a = torch.arange(na, device=dev) + _count_less(b_lb, a_lb, True)
    pos_b = torch.arange(nb, device=dev) + _count_less(a_lb, b_lb, False)
    inv = torch.empty(na + nb, dtype=torch.int64, device=dev)
    inv[pos_a] = torch.arange(na, device=dev)
    inv[pos_b] = na + torch.arange(nb, device=dev)
    lb = torch.cat([a_lb, b_lb])[inv]
    return lb, [torch.cat([pa, pb])[inv] for pa, pb in zip(a_payload,
                                                           b_payload)]


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
                  points_axis=None, lockstep_axes=(),
                  err_share_axis=None) -> PoolState:
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
    `cuda_bounds.source_order` of pcs.  points_axis / lockstep_axes /
    err_share_axis: mesh axes (module doc; parallel/sharding.Axis).
    Returns the final PoolState.
    """
    if pool_update not in ("sort", "merge"):
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
    per_point = lut or clustered_trim or (n_drop > 0 and sharded(points_axis))
    vote_axes = tuple(lockstep_axes) + (points_axis,)

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
        slack = float(trace.to_host(backend.coreset.eps))
    share = None
    if err_share_from is not None:
        share = torch.as_tensor(err_share_from, device=dev).long()

    cp = capacity
    gid0 = torch.arange(cp, device=dev) % g
    in_init = torch.arange(cp, device=dev) < g
    f32 = dict(dtype=torch.float32, device=dev)
    lbs0 = torch.where(in_init & group_active[gid0], torch.zeros((), **f32),
                       torch.full((), INVALID, **f32))
    spans0 = torch.where(in_init, 1.0, 0.0).to(torch.float32)
    if pool_update == "merge":
        # The merge keeps the pool sorted; inactive groups leave INVALID
        # holes among the root slots, so sort once here.
        order0 = torch.argsort(lbs0, stable=True)
        lbs0, gid0, spans0 = lbs0[order0], gid0[order0], spans0[order0]
    s = PoolState(
        lbs=lbs0,
        gids=gid0,
        centers=torch.zeros((cp, 3), **f32),
        spans=spans0,
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

    while s.steps < max_steps and any_live(s.active, vote_axes):
        pop_lb = s.lbs[:lanes]
        pop_gid = s.gids[:lanes]
        pop_c = s.centers[:lanes]
        pop_s = s.spans[:lanes]
        nl = pop_lb.shape[0]
        lane_valid = ((pop_lb < INVALID) & (pop_lb < s.best_err[pop_gid])
                      & s.active[pop_gid])
        gam_t_l = geo.translation_uncertainty_radius(pop_s)
        if per_point:
            lb_pt, ub_pt = bounds_ops.point_terms(
                backend, base[pop_gid] + pop_c[:, None, :],
                gam_ub[pop_gid], gam_lb[pop_gid], gam_t_l)
            if clustered_trim:
                lb_e, ub_e = bounds_ops.reduce_clustered_trimmed(
                    lb_pt, ub_pt, point_weights, trim_keep, trim_ns,
                    points_axis)
            else:
                lb_e = bounds_ops.reduce_point_terms(
                    lb_pt, point_weights, trim_keep, points_axis, trim_ns,
                    drop_mode="over")
                ub_e = bounds_ops.reduce_point_terms(
                    ub_pt, point_weights, trim_keep, points_axis, trim_ns,
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
            if sharded(points_axis):
                lb_e, ub_e = points_axis.psum(lb_e), points_axis.psum(ub_e)
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
            pool_err = (err_share_axis.all_gather(best_err)
                        if sharded(err_share_axis) else best_err)
            donor = pool_err[torch.clamp(share, min=0)]
            best_err = torch.where(share >= 0, torch.minimum(best_err, donor),
                                   best_err)

        # Children inherit the evaluated lb (fgoicp.cpp:159-166).
        split = lane_valid & (lb_e < best_err[pop_gid]) & (pop_s >= min_span)
        ch_c, ch_s = geo.split_octree(pop_c, pop_s)             # [L, 8, 3]
        ch_lb = torch.where(split, lb_e, INVALID)[:, None].expand(nl, 8)
        ch_gid = pop_gid[:, None].expand(nl, 8)

        if pool_update == "sort":
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
            all_gid, all_c, all_s = (all_gid[order], all_c[order],
                                     all_s[order])
            all_lb = all_lb[order]
            rest_lb = all_lb[cp:]
        else:
            # The children's keys: the parents' sorted stably, repeated.
            par_key = torch.where(split, lb_e, INVALID)
            par_order = torch.argsort(par_key, stable=True)
            b_lb = par_key[par_order].repeat_interleave(8)
            all_lb, (all_gid, all_c, all_s) = _merge_sorted(
                s.lbs[lanes:], b_lb,
                (s.gids[lanes:], s.centers[lanes:], s.spans[lanes:]),
                (ch_gid[par_order].reshape(-1),
                 ch_c[par_order].reshape(-1, 3),
                 ch_s[par_order].reshape(-1)))
            keep = ((all_lb < INVALID) & (all_lb < best_err[all_gid])
                    & s.active[all_gid])
            rest_lb = torch.where(keep[cp:], all_lb[cp:], INVALID)
        n_valid = torch.sum(keep)
        dropped = s.dropped + torch.clamp(n_valid - cp, min=0)
        # Certificate soundness under overflow: the per-group minimum lb
        # among dropped (still-valid) nodes clamps the group's lb later.
        dropped_lb = torch.minimum(
            s.dropped_lb, _group_min(rest_lb, all_gid[cp:], g))
        new_lb, new_gid = all_lb[:cp], all_gid[:cp]

        minlb = _group_min(new_lb, new_gid, g)
        converged = (best_err - minlb) < sse_threshold
        empty = minlb >= INVALID
        evaluated = s.evaluated + torch.sum(
            onehot & lane_valid[:, None], dim=0)
        s = PoolState(
            lbs=new_lb, gids=new_gid, centers=all_c[:cp], spans=all_s[:cp],
            best_err=best_err, best_ub=best_ub, best_t=best_t,
            active=s.active & ~(converged | empty), steps=s.steps + 1,
            evaluated=evaluated, dropped=dropped, dropped_lb=dropped_lb)

    trace.count("pool_steps", s.steps)
    # A max_steps exit leaves still-active groups with unexplored frontier
    # nodes whose lb can sit below the group's returned result; fold the
    # surviving per-group frontier minimum into dropped_lb so the consumer's
    # clamp stays a sound lower bound on every exit path.
    exit_minlb = _group_min(s.lbs, s.gids, g)
    return s._replace(dropped_lb=torch.where(
        s.active, torch.minimum(s.dropped_lb, exit_minlb), s.dropped_lb))
