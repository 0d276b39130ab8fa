"""Batched Procrustes ICP.

Counterpart of `fgoicp_tpu/models/icp.py`.  Semantics parity with the
reference's IterativeClosestPoint3D::run (icp3d.cu:80-108): apply the
initial (R0, t0), then iterate (correspondences -> Procrustes -> compose ->
exact SSE) while the relative SSE improvement exceeds the convergence
threshold, up to max_iter, and return the better of the last two iterates.

G problems run in lockstep with per-lane `done` masks.  The JAX package's
`lax.while_loop` is a Python loop here whose condition, the count of lanes
still running, is read on the host once per iteration (`trace.to_host`).
An iteration is `ops/cuda_icp.icp_align` (correspondences, Procrustes, the
pose update, the points moved in place), the NN query, and
`ops/cuda_icp.icp_commit` (the SSE, the loop guard, the running count):
on the card two hand-written kernels around the NN kernel, three launches;
on the CPU their plain versions, the plain torch ops of `ops/procrustes.py`
and masked selects.  A trimmed ICP feeds its keep mask to icp_align as the
weights and its kept sum to icp_commit.  Inside a request (utils/trace.py)
an `icp_batched` call is an "icp" span that counts its lockstep iterations
("icp_iterations") and lanes, and `exact_sse_batched` an "icp.rescore"
span; the record's `icp_commit` launches are the iterations the kernels
ran.

Target sharding (parallel/bnb.py::icp_sharded): with `target_axis`, a mesh
axis of parallel/sharding.py, pct is still the FULL target, which every
rank holds; each rank runs the NN kernels on its slice of it
(`target_shard`).  The global minimum d2 is a pmin, the winner the
smallest global index among the shards that reach it (a second pmin), and
its point is read from the full target, the same row on every rank.  So
the sharded ICP equals the single-device one bit for bit.  (The JAX
package's shard_map body sees only its own rows and fetches the point
with a masked psum; a rank here needs no collective for it.)
"""

from __future__ import annotations

import torch

from ..ops import cuda_icp
from ..ops import nn as nn_ops
from ..parallel.sharding import sharded
from ..utils import debug
from ..utils import trace

BIG = 1e10  # reference M_INF
NO_VOTE = 2 ** 31 - 1   # a shard's index vote when it does not hold the min
FAR = 1e6   # padded target rows: far from every query, they never win


def _lane_weights(point_weights, trim_keep, g: int, ns: int, device):
    """point_weights ([ns] or [G, ns]) as a contiguous [G, ns] float32, or
    None.
    0 marks padding rows (the ragged serving batch); soft values weight
    Procrustes and the SSE."""
    if point_weights is None:
        return None
    if _trimmed(trim_keep, ns):
        # Padding zeros would displace real points from the trim keep-set;
        # the ragged serving path forbids trimming instead.
        raise ValueError("point_weights cannot combine with trim_keep")
    w = torch.as_tensor(point_weights, dtype=torch.float32, device=device)
    return w.expand(g, ns).contiguous()


def _transform(R: torch.Tensor, pcs: torch.Tensor, t: torch.Tensor):
    """R @ p + t per lane: pcs [ns, 3] is shared by the lanes, [G, ns, 3]
    gives each lane its own source (the batched serving mode)."""
    spec = "gnc" if pcs.ndim == 3 else "nc"
    return torch.einsum(f"grc,{spec}->gnr", R, pcs) + t[:, None, :]


def _trimmed(trim_keep, ns):
    return trim_keep is not None and trim_keep < ns


def trimmed_sum(d2: torch.Tensor, trim_keep, weights=None) -> torch.Tensor:
    """Sum of the trim_keep smallest entries of d2 [G, ns] per lane (all
    of them without trimming), each weighted by `weights` [G, ns] when
    given (weights never combine with trimming)."""
    if weights is not None:
        d2 = d2 * weights
    if not _trimmed(trim_keep, d2.shape[-1]):
        return torch.sum(d2, dim=-1)
    return torch.sum(torch.topk(d2, trim_keep, dim=-1, largest=False).values,
                     dim=-1)


def trim_mask(d2: torch.Tensor, trim_keep, weights=None):
    """1 for the points whose d2 is at most the trim_keep-th smallest (ties
    keep extra points, as in the JAX package), else 0; untrimmed, the
    point weights themselves (None without them)."""
    if not _trimmed(trim_keep, d2.shape[-1]):
        return weights
    thr = torch.kthvalue(d2, trim_keep, dim=-1).values
    return (d2 <= thr[..., None]).to(torch.float32)


def target_shard(pct: torch.Tensor, target_axis):
    """(this rank's rows of the full target pct, padded with FAR rows to a
    multiple of the axis size, and the global index of its first row);
    (pct, 0) when the axis is not sharded."""
    if not sharded(target_axis):
        return pct, 0
    extra = -pct.shape[0] % target_axis.size
    if extra:
        pct = torch.cat([pct, pct.new_full((extra, 3), FAR)])
    rows = pct.shape[0] // target_axis.size
    return target_axis.shard(pct), target_axis.index * rows


def _nn_query(pct_l, cur, target_axis, offset):
    """(d2, global idx) [M] of the queries cur [..., 3] against the target,
    pct_l this rank's rows from global row `offset`, voted over
    target_axis when it is sharded (module doc)."""
    d2, idx = nn_ops.nearest_neighbor(cur, pct_l)
    if not sharded(target_axis):
        return d2, idx
    best_d2 = target_axis.pmin(d2)
    vote = torch.where(d2 <= best_d2, idx + offset, NO_VOTE)
    return best_d2, target_axis.pmin(vote)


@trace.spanned("icp")
@debug.checked("icp_batched")
def icp_batched(pct: torch.Tensor, pcs: torch.Tensor, R0: torch.Tensor,
                t0: torch.Tensor, active=None, max_iter: int = 100,
                convergence_threshold: float = 0.005, trim_keep=None,
                target_axis=None, point_weights=None):
    """Run G ICP problems in lockstep.

    pct [nt, 3] target, pcs [ns, 3] source shared by the lanes or [G, ns,
    3] one source per lane (the batched serving mode), R0 [G, 3, 3], t0
    [G, 3] float32 tensors on one device; active [G] bool (inactive lanes
    are skipped).  trim_keep: Procrustes takes only the trim_keep best
    correspondences and the SSE sums only the trim_keep smallest residuals
    (trimmed ICP).  point_weights: [ns] or [G, ns] per-point weights of
    Procrustes and the SSE (0 marks padding; not with trim_keep).
    target_axis: the target's mesh axis; each rank searches its shard of
    pct (module doc).
    Returns (sse [G], R [G, 3, 3], t [G, 3]).
    """
    g, ns = R0.shape[0], pcs.shape[-2]
    w = _lane_weights(point_weights, trim_keep, g, ns, pcs.device)
    if active is None:
        active = torch.ones(g, dtype=torch.bool, device=pcs.device)

    pct_l, offset = target_shard(pct, target_axis)

    def nn_query(cur):
        d2, idx = _nn_query(pct_l, cur, target_axis, offset)
        return d2.reshape(g, ns), idx.reshape(g, ns)

    # Per-lane sources change only the first transform: the loop carries
    # the transformed points either way, updated in place.
    cur = _transform(R0, pcs, t0).contiguous()
    d2, idx = nn_query(cur)
    sse = torch.full((g,), BIG, dtype=torch.float32, device=pcs.device)
    last_sse = torch.full((g,), 2 * BIG, dtype=torch.float32, device=pcs.device)
    R = R0.clone(memory_format=torch.contiguous_format)
    t = t0.clone(memory_format=torch.contiguous_format)
    last_R, last_t = R.clone(), t.clone()
    done = ~active
    running = torch.sum(active, dtype=torch.int32).reshape(1)
    target = pct.contiguous()
    it = 0
    while it < max_iter and int(trace.to_host(running)[0]) > 0:
        # Correspondences on the current (pre-update) points (icp3d.cu:146),
        # carried from the previous iteration's single NN pass: the SSE
        # query of iteration k is the correspondence query of k+1.
        cuda_icp.icp_align(target, idx, trim_mask(d2, trim_keep, w), done,
                           cur, R, t, last_R, last_t, running)
        d2, idx = nn_query(cur)
        if _trimmed(trim_keep, ns):
            cuda_icp.icp_commit(trimmed_sum(d2, trim_keep)[:, None], None,
                                convergence_threshold, done, sse, last_sse,
                                running)
        else:
            cuda_icp.icp_commit(d2, w, convergence_threshold, done, sse,
                                last_sse, running)
        it += 1
    trace.count("icp_iterations", it)
    trace.count("icp_lanes", g)

    # Return the better of the last two iterates (icp3d.cu:106-107).
    better = sse < last_sse
    return (torch.where(better, sse, last_sse),
            cuda_icp.masked(better, R, last_R),
            cuda_icp.masked(better, t, last_t))


@trace.spanned("icp.rescore")
@debug.checked("exact_sse_batched")
def exact_sse_batched(pct: torch.Tensor, pcs: torch.Tensor, R: torch.Tensor,
                      t: torch.Tensor, trim_keep=None, target_axis=None,
                      point_weights=None) -> torch.Tensor:
    """Exact (optionally trimmed or weighted) SSE [G] of G poses against
    the full target, in one NN pass — used to re-anchor incumbents produced
    by proxy-target search ICPs on the true objective (models/goicp.py).
    pcs: [ns, 3] shared source or [G, ns, 3] per-lane sources.  With a
    sharded target_axis, each rank searches its shard of the full target
    pct and the per-query minima are pmin'd before the sum."""
    g, ns = R.shape[0], pcs.shape[-2]
    w = _lane_weights(point_weights, trim_keep, g, ns, pcs.device)
    cur = _transform(R, pcs, t)
    d2 = nn_ops.nearest_sqdist(cur, target_shard(pct, target_axis)[0])
    d2 = d2.reshape(g, ns)
    if sharded(target_axis):
        d2 = target_axis.pmin(d2)
    return trimmed_sum(d2, trim_keep, w)


def icp_register(pct: torch.Tensor, pcs: torch.Tensor, R0=None, t0=None,
                 max_iter: int = 100, convergence_threshold: float = 0.005,
                 **kw):
    """Single-pair ICP (reference config 1: plain ICP on a cloud pair)."""
    dev = pcs.device
    R0 = (torch.eye(3, dtype=torch.float32, device=dev) if R0 is None
          else torch.as_tensor(R0, dtype=torch.float32, device=dev))
    t0 = (torch.zeros(3, dtype=torch.float32, device=dev) if t0 is None
          else torch.as_tensor(t0, dtype=torch.float32, device=dev))
    sse, R, t = icp_batched(pct, pcs, R0[None], t0[None], max_iter=max_iter,
                            convergence_threshold=convergence_threshold, **kw)
    return sse[0], R[0], t[0]
