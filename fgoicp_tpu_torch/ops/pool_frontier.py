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

Everything a step does after the lane evaluation is a commit
(ops/cuda_pool.py): the "sort" update off a sharded mesh is `pool_commit`,
one CUDA launch on the card (the plain torch ops on the CPU), which also
writes the next step's lane inputs and the live flag; the merge update and
sharded meshes take `pool_commit_plain`, with the mesh's all-gather and
psum'd live vote.

The JAX `lax.while_loop` is a Python loop whose condition is read on the
host once per step: on the card a step is the lane kernel, `pool_commit`
and that read.  Every sort is `torch.argsort(stable=True)` (and the
kernel's merge lands each node where it would): the 8 children of a node
share their parent's lb, and `jnp.argsort` is stable, so an unstable sort
would change the pool order and the node counts.

Pool overflow and the certificate: when valid nodes exceed `capacity`, the
worst-lb nodes are dropped (counted in `dropped`) and the per-group minimum
dropped lb is kept in `dropped_lb` ([G], INVALID when none); the consumer
must clamp its lower bound with it (models/goicp.py does).  A max_steps exit
folds the surviving frontier minimum of still-active groups into
`dropped_lb` the same way.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import bounds as bounds_ops
from . import cuda_bounds, cuda_pool
from . import geometry as geo
from ..parallel.sharding import any_live, sharded
from ..utils import trace
# The state, the sentinels and the update's helpers live with the commit.
from .cuda_pool import (BIG, INVALID, PoolState, _count_less,  # noqa: F401
                        _group_min, _merge_sorted)


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
        share = torch.as_tensor(err_share_from, device=dev).long() \
            .contiguous()

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
    # The "sort" update off a sharded mesh commits through `pool_commit`
    # (one launch on the card), which also writes the next step's lane
    # inputs and the live flag into `buf`; the merge update and sharded
    # meshes take the plain commit, with the lane inputs made here and the
    # live vote psum'd by `any_live`.
    buf = None
    if pool_update == "sort" and not any(
            sharded(a) for a in (err_share_axis, *vote_axes)):
        buf = cuda_pool.CommitBuffers(s, lanes)

    def live(s):
        if s.steps >= max_steps:
            return False
        if buf is None:
            return any_live(s.active, vote_axes)
        return bool(trace.to_host(buf.live)[0])

    while live(s):
        pop_gid = s.gids[:lanes]
        pop_c = s.centers[:lanes]
        if buf is None:
            pop_gid32 = pop_gid.to(torch.int32)
            gam_t_l = geo.translation_uncertainty_radius(
                s.spans[:lanes]).contiguous()
        else:
            pop_gid32, gam_t_l = buf.lane_gid, buf.gam_t
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
                base, pop_gid32, pop_c.contiguous(), backend.buckets, gam_ub,
                gam_t_l, slack, n_drop, point_weights=point_weights,
                gam_lb=gam_lb, point_order=point_order)
        else:
            lb_e, ub_e = cuda_bounds.fused_bounds_lanes(
                base, pop_gid32, pop_c.contiguous(), backend.buckets, gam_ub,
                gam_t_l, slack, point_weights=point_weights, gam_lb=gam_lb,
                point_order=point_order)
            if sharded(points_axis):
                lb_e, ub_e = points_axis.psum(lb_e), points_axis.psum(ub_e)
        if buf is None:
            s = cuda_pool.pool_commit_plain(
                s, lb_e, ub_e, share, min_span, sse_threshold,
                pool_update=pool_update, err_share_axis=err_share_axis)
        else:
            s = cuda_pool.pool_commit(s, lb_e, ub_e, share, min_span,
                                      sse_threshold, buf)

    trace.count("pool_steps", s.steps)
    # A max_steps exit leaves still-active groups with unexplored frontier
    # nodes whose lb can sit below the group's returned result; fold the
    # surviving per-group frontier minimum into dropped_lb so the consumer's
    # clamp stays a sound lower bound on every exit path.
    exit_minlb = _group_min(s.lbs, s.gids, g)
    return s._replace(dropped_lb=torch.where(
        s.active, torch.minimum(s.dropped_lb, exit_minlb), s.dropped_lb))
