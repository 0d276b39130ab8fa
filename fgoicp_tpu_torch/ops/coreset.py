"""Proxy coreset for bound evaluation (farthest-point sampling + covering
radius) and weighted source clusters.

Counterpart of `fgoicp_tpu/ops/coreset.py`; FPS picks the same indices
(start `seed % n`, first index among equal maxima, distances rounded in the
same order), so proxy sets and clusters match the JAX package's.

Validity: for a proxy set S of the target T with covering radius
eps = max_{t in T} dist(t, S), d_S(q) - eps <= d_T(q) <= d_S(q) for every
query q: upper bounds use d_S, lower bounds subtract eps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import nn as nn_ops
# The plain loop on the CPU, one kernel launch on the card; inside a
# request a "construct.fps" span that counts its k - 1 steps.
from .cuda_fps import farthest_point_sample


class ProxyCoreset(NamedTuple):
    points: torch.Tensor   # [P, 3] proxy subset of the target
    eps: torch.Tensor      # 0-d covering radius


class SourceClusters(NamedTuple):
    """Weighted clustering of the source cloud for hierarchical bounds:
    each source point is assigned to its nearest representative; a cluster
    of m_k points with radius delta_k contributes m_k times its
    representative's bound terms, with delta_k folded into both bounds
    (ops/bounds.gamma_arrays)."""

    reps: torch.Tensor     # [K, 3] representatives
    weights: torch.Tensor  # [K] member counts (float)
    deltas: torch.Tensor   # [K] cluster radii


def build_weighted(points: torch.Tensor, size: int = 1024,
                   seed: int = 0) -> SourceClusters:
    """Cluster a source cloud: FPS representatives + nearest assignment."""
    n = points.shape[0]
    if n <= size:
        return SourceClusters(
            points, torch.ones(n, dtype=torch.float32, device=points.device),
            torch.zeros(n, dtype=torch.float32, device=points.device))
    reps = points[farthest_point_sample(points, size, seed)]
    d2, assign = nn_ops.nearest_neighbor(points, reps)
    d = torch.sqrt(torch.clamp(d2, min=0.0))
    assign = assign.long()
    weights = torch.zeros(size, dtype=torch.float32, device=points.device)
    weights.index_add_(0, assign, torch.ones_like(d))
    deltas = torch.zeros(size, dtype=torch.float32, device=points.device)
    deltas.scatter_reduce_(0, assign, d, reduce="amax")
    return SourceClusters(reps, weights, deltas)


def build(target: torch.Tensor, size: int = 4096,
          seed: int = 0) -> ProxyCoreset:
    """Build the proxy coreset.  A target no larger than `size` is used
    whole (eps = 0: the bounds become exact-NN bounds)."""
    nt = target.shape[0]
    if nt <= size:
        return ProxyCoreset(points=target, eps=torch.zeros(
            (), dtype=torch.float32, device=target.device))
    proxies = target[farthest_point_sample(target, size, seed)]
    # Exact covering radius: max over the target of the distance to the
    # proxy set.
    d2 = nn_ops.nearest_sqdist(target, proxies)
    eps = torch.sqrt(torch.clamp(torch.max(d2), min=0.0))
    return ProxyCoreset(points=proxies, eps=eps)


def state_from_numpy(arrays: dict, device) -> tuple:
    """(ProxyCoreset, SourceClusters or None) from numpy arrays — e.g. the
    JAX package's built search state — so that bounds and frontiers can be
    run on exactly the same proxies and clusters.

    arrays: `points` [P, 3] and `eps` (proxy coreset); optionally `reps`
    [K, 3], `weights` [K] and `deltas` [K] (source clusters)."""
    def f32(key):
        return torch.as_tensor(np.array(arrays[key], np.float32),
                               device=device)

    cs = ProxyCoreset(points=f32("points").reshape(-1, 3).contiguous(),
                      eps=f32("eps").reshape(()))
    clusters = None
    if "reps" in arrays:
        clusters = SourceClusters(reps=f32("reps").reshape(-1, 3).contiguous(),
                                  weights=f32("weights"), deltas=f32("deltas"))
    return cs, clusters
