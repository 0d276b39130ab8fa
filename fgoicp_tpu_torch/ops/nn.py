"""Exact nearest-neighbour search and SSE.

Counterpart of `fgoicp_tpu/ops/nn.py`.  Every query goes through the
exact direct-difference kernels of `ops/cuda_nn.py` (their plain torch
versions for CPU tensors); there is no norm-expansion ranking path here,
so no winner rescore is needed.
"""

from __future__ import annotations

import torch

from . import cuda_nn

BIG = cuda_nn.BIG  # reference M_INF (common.hpp:18)


def nearest_sqdist(queries: torch.Tensor, pct: torch.Tensor) -> torch.Tensor:
    """Min squared distance from each query [..., 3] to the target [nt, 3]
    -> [M] with M = prod(queries.shape[:-1])."""
    return cuda_nn.nn_min(queries.reshape(-1, 3).contiguous(),
                          pct.contiguous())


def nearest_neighbor(queries: torch.Tensor, pct: torch.Tensor):
    """(min squared distance [M] f32, argmin index [M] i32) per query."""
    return cuda_nn.nn_argmin(queries.reshape(-1, 3).contiguous(),
                             pct.contiguous())


def exact_sse(pct: torch.Tensor, pcs: torch.Tensor, R: torch.Tensor,
              t: torch.Tensor, trim_fraction: float = 0.0) -> torch.Tensor:
    """Exact SSE of the transformed source against the target:
    sum_i min_j ||R p_i + t - q_j||^2 (registration.cu:62-86).  With
    trim_fraction > 0, sums only the keep = max(1, round(ns * (1 -
    trim_fraction))) smallest residuals."""
    q = pcs @ R.T + t
    d2 = nearest_sqdist(q, pct)
    if trim_fraction > 0.0:
        keep = max(1, int(round(d2.shape[0] * (1.0 - trim_fraction))))
        d2 = torch.sort(d2).values[:keep]
    return torch.sum(d2)
