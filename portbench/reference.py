"""The plain reference: the registration objective, worked out again from
the inputs (plain torch; nothing of the program, no TF32).

Go-ICP's objective for a pose (R, t) of a source on a target is the sum
over source points of the squared distance to the nearest target point,
in the normalized frame: both clouds centred on their own means and scaled
by s = 1 / (the largest absolute coordinate of the centred source).  With
world poses R @ source + t ~ target that is

    SSE(R, t) = s^2 * sum_i min_j |R src_i + t - tgt_j|^2,

evaluated here in that frame: q_i = R (src_i - mu_s) s + (R mu_s + t - mu_t)
s against (tgt_j - mu_t) s.  Squared distances are exact float32
differences (dx^2 + dy^2 + dz^2, never the norm expansion), their minimum
per point is summed in float64.  Queries go in blocks, so any size fits.

`sse_tf32` is the control: the same objective with the distances from the
norm expansion |q|^2 + |p|^2 - 2 q.p and the cross term on TF32 operands
(10 mantissa bits, products summed in float32), as a tensor-core
nearest-neighbour search would compute them.
"""

from __future__ import annotations

import numpy as np
import torch

# Elements of one [queries, targets] block.
BLOCK = 1 << 24


def frame(target: np.ndarray, source: np.ndarray):
    """(mu_t, mu_s, s) of the normalized frame, in float64."""
    tgt = np.asarray(target, np.float64)
    src = np.asarray(source, np.float64)
    mu_t, mu_s = tgt.mean(axis=0), src.mean(axis=0)
    return mu_t, mu_s, 1.0 / np.abs(src - mu_s).max()


def _frame_tensors(target, source, R, t, device):
    mu_t, mu_s, s = frame(target, source)
    R64 = np.asarray(R, np.float64)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    tgt = f32((np.asarray(target, np.float64) - mu_t) * s)
    src = f32((np.asarray(source, np.float64) - mu_s) * s)
    t_n = f32((R64 @ mu_s + np.asarray(t, np.float64) - mu_t) * s)
    Rt = f32(R64)
    # R @ p + t_n per point, by explicit float32 products (no matmul).
    q = (src[:, 0:1] * Rt[:, 0] + src[:, 1:2] * Rt[:, 1]
         + src[:, 2:3] * Rt[:, 2] + t_n)
    return tgt, q, s


def _blocks(q, tgt):
    step = max(1, BLOCK // max(1, tgt.shape[0]))
    for i in range(0, q.shape[0], step):
        yield q[i:i + step]


def sse(target, source, R, t, device="cpu") -> float:
    """The normalized-frame SSE of the world pose (R, t)."""
    tgt, q, _ = _frame_tensors(target, source, R, t, device)
    total = 0.0
    for qb in _blocks(q, tgt):
        dx = qb[:, None, 0] - tgt[None, :, 0]
        dy = qb[:, None, 1] - tgt[None, :, 1]
        dz = qb[:, None, 2] - tgt[None, :, 2]
        d2 = dx * dx + dy * dy + dz * dz
        total += float(torch.amin(d2, dim=1).double().sum())
    return total


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (nearest, ties to even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


def sse_tf32(target, source, R, t, device="cpu") -> float:
    """The control: sse() with the norm expansion on TF32 operands."""
    tgt, q, _ = _frame_tensors(target, source, R, t, device)
    tn = torch.sum(tgt * tgt, dim=1)
    tr = round_tf32(tgt)
    total = 0.0
    for qb in _blocks(q, tgt):
        qn = torch.sum(qb * qb, dim=1)
        cross = round_tf32(qb) @ tr.T
        d2 = qn[:, None] + tn[None, :] - 2.0 * cross
        total += float(torch.clamp(torch.amin(d2, dim=1), min=0.0)
                       .double().sum())
    return total
