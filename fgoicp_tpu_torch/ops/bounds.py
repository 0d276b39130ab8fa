"""SE(3) bound ingredients for the proxy backend.

Counterpart of the proxy half of `fgoicp_tpu/ops/bounds.py` (parity
target: the reference's kernComputeBounds, registration.cu:27-60).  Per
(rotation node g, translation node, source point i) with q = R_g p_i + t and
d an estimate of the distance from q to the target:

    gamma_r[g,i] = rotation uncertainty radius (0 when rotation is fixed)
    gamma_t      = sqrt(3) * translation half-span
    ub = sum_i relu(d_ub - gamma_r)^2
    lb = sum_i relu(d_lb - gamma_r - gamma_t)^2

Backends: `proxy` (exact NN against a farthest-point coreset of the
target, d_lb = d - eps_cover) and `exact` (the proxy backend over
the full target, eps = 0).  The LUT backend and trimming are not ported
(ROADMAP Queue 1 items 14 and 10).  The pooled frontier evaluates these
bounds with the fused lane kernel (ops/cuda_bounds.py).
"""

from __future__ import annotations

import dataclasses

import torch

from . import coreset as coreset_ops
from . import geometry as geo
from . import nn as nn_ops


@dataclasses.dataclass(frozen=True)
class ProxyBackend:
    """Exact NN against a proxy coreset of the target.  Distances here are
    always exact f32 differences, so the JAX backend's ranking slack
    (`eps_rank`, for reduced-precision matmul ranking) has no counterpart:
    the lower-bound slack is the covering radius alone."""
    coreset: coreset_ops.ProxyCoreset


def make_backend(target: torch.Tensor, kind: str = "proxy",
                 proxy_size: int = 4096, seed: int = 0) -> ProxyBackend:
    """Build a distance backend over the (normalized) target cloud."""
    if kind == "proxy":
        return ProxyBackend(
            coreset=coreset_ops.build(target, size=proxy_size, seed=seed))
    if kind == "exact":
        return ProxyBackend(coreset=coreset_ops.ProxyCoreset(
            points=target, eps=torch.zeros((), dtype=torch.float32,
                                           device=target.device)))
    if kind == "lut":
        raise NotImplementedError(
            "the LUT bound backend is ROADMAP Queue 1 item 14")
    raise ValueError(f"Unknown bound backend: {kind}")


def gamma_arrays(norms: torch.Tensor, rot_spans: torch.Tensor,
                 fix_rot: torch.Tensor, ref_compat: bool = False,
                 point_deltas=None):
    """Per-(group, point) radii (gam_ub, gam_lb) [G, ns] subtracted from d
    in the upper/lower bound terms.

    Plain point sources: both equal the rotation uncertainty radius (zero
    for fixed-rotation groups).  With weighted source clusters of radius
    delta, the member distance lies within +-delta of the representative's
    and the member norm within +-delta, so
        gam_ub = gamma(max(|q| - delta, 0)) - delta     (term overestimate)
        gam_lb = gamma(|q| + delta) + delta             (term underestimate)
    keep both bounds valid for the cluster sums.
    """
    spans = rot_spans[:, None]
    fix = fix_rot[:, None]
    if point_deltas is None:
        g = geo.rotation_uncertainty_radius(norms[None, :], spans,
                                            ref_compat=ref_compat)
        g = torch.where(fix, 0.0, g)
        return g, g
    d = point_deltas[None, :]
    g_min = geo.rotation_uncertainty_radius(
        torch.clamp(norms[None, :] - d, min=0.0), spans, ref_compat=ref_compat)
    g_max = geo.rotation_uncertainty_radius(
        norms[None, :] + d, spans, ref_compat=ref_compat)
    gam_ub = torch.where(fix, 0.0, g_min) - d
    gam_lb = torch.where(fix, 0.0, g_max) + d
    return gam_ub, gam_lb


def distance_estimates(backend: ProxyBackend, queries: torch.Tensor):
    """(d_ub, d_lb) per query [..., 3]: d_lb <= d_target(q) <= d_ub."""
    if not isinstance(backend, ProxyBackend):
        raise TypeError(f"Unknown backend type: {type(backend)}")
    shape = queries.shape[:-1]
    d2 = nn_ops.nearest_sqdist(queries, backend.coreset.points)
    d = torch.sqrt(torch.clamp(d2, min=0.0)).reshape(shape)
    return d, d - backend.coreset.eps
