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


def _unported(trim_keep, point_weights, pcs):
    if point_weights is not None and trim_keep is not None \
            and trim_keep < pcs.shape[-2]:
        # Padding zeros would displace real points from the trim keep-set.
        raise ValueError("point_weights cannot combine with trim_keep")
    if point_weights is not None or pcs.ndim == 3:
        raise NotImplementedError(
            "point_weights and per-lane [G, ns, 3] sources are the serving "
            "mode, ROADMAP Queue 1 item 13")


def _trimmed(trim_keep, ns):
    return trim_keep is not None and trim_keep < ns


def trimmed_sum(d2: torch.Tensor, trim_keep) -> torch.Tensor:
    """Sum of the trim_keep smallest entries of d2 [G, ns] per lane (all
    of them without trimming)."""
    if not _trimmed(trim_keep, d2.shape[-1]):
        return torch.sum(d2, dim=-1)
    return torch.sum(torch.topk(d2, trim_keep, dim=-1, largest=False).values,
                     dim=-1)


def trim_mask(d2: torch.Tensor, trim_keep):
    """1 for the points whose d2 is at most the trim_keep-th smallest (ties
    keep extra points, as in the JAX package), else 0; None untrimmed."""
    if not _trimmed(trim_keep, d2.shape[-1]):
        return None
    thr = torch.kthvalue(d2, trim_keep, dim=-1).values
    return (d2 <= thr[..., None]).to(torch.float32)


def icp_batched(pct: torch.Tensor, pcs: torch.Tensor, R0: torch.Tensor,
                t0: torch.Tensor, active=None, max_iter: int = 100,
                convergence_threshold: float = 0.005, trim_keep=None,
                target_axis=None, point_weights=None):
    """Run G ICP problems in lockstep.

    pct [nt, 3] target, pcs [ns, 3] source, R0 [G, 3, 3], t0 [G, 3]
    float32 tensors on one device; active [G] bool (inactive lanes are
    skipped).  trim_keep: Procrustes takes only the trim_keep best
    correspondences and the SSE sums only the trim_keep smallest residuals
    (trimmed ICP).  Returns (sse [G], R [G, 3, 3], t [G, 3]).
    """
    _unported(trim_keep, point_weights, pcs)
    if target_axis is not None:
        raise NotImplementedError(
            "target-sharded ICP is ROADMAP Queue 1 item 16 (multi-GPU)")
    g, ns = R0.shape[0], pcs.shape[0]
    if active is None:
        active = torch.ones(g, dtype=torch.bool, device=pcs.device)

    def nn_query(cur):
        d2, idx = nn_ops.nearest_neighbor(cur, pct)
        return d2.reshape(g, ns), idx.reshape(g, ns)

    cur = torch.einsum("grc,nc->gnr", R0, pcs) + t0[:, None, :]
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
        R_, t_ = proc_ops.procrustes(cur, corr, mask=trim_mask(d2, trim_keep))
        new_cur = torch.einsum("grc,gnc->gnr", R_, cur) + t_[:, None, :]
        new_R = torch.einsum("gab,gbc->gac", R_, R)
        new_t = torch.einsum("gab,gb->ga", R_, t) + t_
        d2n, idxn = nn_query(new_cur)
        new_sse = trimmed_sum(d2n, trim_keep)

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
    """Exact (optionally trimmed) SSE [G] of G poses against the full
    target, in one NN pass — used to re-anchor incumbents produced by
    proxy-target search ICPs on the true objective (models/goicp.py)."""
    _unported(trim_keep, point_weights, pcs)
    if target_axis is not None:
        raise NotImplementedError(
            "target-sharded SSE is ROADMAP Queue 1 item 16 (multi-GPU)")
    g, ns = R.shape[0], pcs.shape[0]
    cur = torch.einsum("grc,nc->gnr", R, pcs) + t[:, None, :]
    return trimmed_sum(nn_ops.nearest_sqdist(cur, pct).reshape(g, ns),
                       trim_keep)


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
