"""Batched Procrustes ICP.

Counterpart of `fgoicp_tpu/models/icp.py`.  Semantics parity with the
reference's IterativeClosestPoint3D::run (icp3d.cu:80-108): apply the
initial (R0, t0), then iterate (correspondences -> Procrustes -> compose ->
exact SSE) while the relative SSE improvement exceeds the convergence
threshold, up to max_iter, and return the better of the last two iterates.

G problems run in lockstep with per-lane `done` masks.  The JAX package's
`lax.while_loop` is a Python loop here whose condition is read on the host
once per iteration.
"""

from __future__ import annotations

import torch

from ..ops import nn as nn_ops
from ..ops import procrustes as proc_ops

BIG = 1e10  # reference M_INF


def _masked(pred: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    """Select new where pred (per lane), broadcasting over trailing dims."""
    shape = pred.shape + (1,) * (new.ndim - pred.ndim)
    return torch.where(pred.reshape(shape), new, old)


def _lane_weights(point_weights, trim_keep, g: int, ns: int, device):
    """point_weights ([ns] or [G, ns]) broadcast to [G, ns] float32, or None.
    0 marks padding rows (the ragged serving batch); soft values weight
    Procrustes and the SSE."""
    if point_weights is None:
        return None
    if _trimmed(trim_keep, ns):
        # Padding zeros would displace real points from the trim keep-set;
        # the ragged serving path forbids trimming instead.
        raise ValueError("point_weights cannot combine with trim_keep")
    w = torch.as_tensor(point_weights, dtype=torch.float32, device=device)
    return w.expand(g, ns)


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
    Returns (sse [G], R [G, 3, 3], t [G, 3]).
    """
    if target_axis is not None:
        raise NotImplementedError(
            "target-sharded ICP is ROADMAP Queue 1 item 16 (multi-GPU)")
    g, ns = R0.shape[0], pcs.shape[-2]
    w = _lane_weights(point_weights, trim_keep, g, ns, pcs.device)
    if active is None:
        active = torch.ones(g, dtype=torch.bool, device=pcs.device)

    def nn_query(cur):
        d2, idx = nn_ops.nearest_neighbor(cur, pct)
        return d2.reshape(g, ns), idx.reshape(g, ns)

    # Per-lane sources change only the first transform: the loop carries
    # the transformed points either way.
    cur = _transform(R0, pcs, t0)
    d2, idx = nn_query(cur)
    sse = torch.full((g,), BIG, dtype=torch.float32, device=pcs.device)
    last_sse = torch.full((g,), 2 * BIG, dtype=torch.float32, device=pcs.device)
    R, t, last_R, last_t = R0, t0, R0, t0
    done = ~active
    it = 0
    while it < max_iter and not bool(torch.all(done)):
        run = ~done
        # Correspondences on the current (pre-update) points (icp3d.cu:146),
        # carried from the previous iteration's single NN pass: the SSE
        # query of iteration k is the correspondence query of k+1.
        corr = pct[idx.long()]
        R_, t_ = proc_ops.procrustes(cur, corr,
                                     mask=trim_mask(d2, trim_keep, w))
        new_cur = torch.einsum("grc,gnc->gnr", R_, cur) + t_[:, None, :]
        new_R = torch.einsum("gab,gbc->gac", R_, R)
        new_t = torch.einsum("gab,gb->ga", R_, t) + t_
        d2n, idxn = nn_query(new_cur)
        new_sse = trimmed_sum(d2n, trim_keep, w)

        last_sse = _masked(run, sse, last_sse)
        sse = _masked(run, new_sse, sse)
        last_R = _masked(run, R, last_R)
        last_t = _masked(run, t, last_t)
        R = _masked(run, new_R, R)
        t = _masked(run, new_t, t)
        cur = _masked(run, new_cur, cur)
        d2 = _masked(run, d2n, d2)
        idx = _masked(run, idxn, idx)
        # Reference loop guard: continue while
        # (last_sse - sse) > threshold * last_sse (icp3d.cu:94).
        conv = (last_sse - sse) <= convergence_threshold * last_sse
        done = done | (run & conv)
        it += 1

    # Return the better of the last two iterates (icp3d.cu:106-107).
    better = sse < last_sse
    return (torch.where(better, sse, last_sse), _masked(better, R, last_R),
            _masked(better, t, last_t))


def exact_sse_batched(pct: torch.Tensor, pcs: torch.Tensor, R: torch.Tensor,
                      t: torch.Tensor, trim_keep=None, target_axis=None,
                      point_weights=None) -> torch.Tensor:
    """Exact (optionally trimmed or weighted) SSE [G] of G poses against
    the full target, in one NN pass — used to re-anchor incumbents produced
    by proxy-target search ICPs on the true objective (models/goicp.py).
    pcs: [ns, 3] shared source or [G, ns, 3] per-lane sources."""
    if target_axis is not None:
        raise NotImplementedError(
            "target-sharded SSE is ROADMAP Queue 1 item 16 (multi-GPU)")
    g, ns = R.shape[0], pcs.shape[-2]
    w = _lane_weights(point_weights, trim_keep, g, ns, pcs.device)
    cur = _transform(R, pcs, t)
    return trimmed_sum(nn_ops.nearest_sqdist(cur, pct).reshape(g, ns),
                       trim_keep, w)


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
