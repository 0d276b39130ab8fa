"""SE(3) bound ingredients: the proxy and LUT backends.

Counterpart of `fgoicp_tpu/ops/bounds.py` (parity target: the reference's
kernComputeBounds, registration.cu:27-60).  Per (rotation node g,
translation node, source point i) with q = R_g p_i + t and d an estimate of
the distance from q to the target:

    gamma_r[g,i] = rotation uncertainty radius (0 when rotation is fixed)
    gamma_t      = sqrt(3) * translation half-span
    ub = sum_i relu(d_ub - gamma_r)^2
    lb = sum_i relu(d_lb - gamma_r - gamma_t)^2

Backends: `proxy` (exact NN against a farthest-point coreset of the
target, d_lb = d - eps_cover), `exact` (the proxy backend over the full
target, eps = 0) and `lut` (a distance-field lookup, ops/distance_field.py:
the reference's approach; conservative by default, with the field's
builder, storage and interpolation errors folded into an asymmetric
bracket).  For proxy backends the pooled frontier evaluates these bounds
with the fused lane kernels and the grouped scheduler with the fused grid
kernel (ops/cuda_bounds.py, through `evaluate_bounds`); LUT nodes go through
`point_terms` and the torch reductions, as the JAX package's XLA path.

Trimming: with trim_keep = K < ns, per-node sums keep only the K smallest
per-point terms (`reduce_point_terms`); over weighted source clusters the
member-level trim is `reduce_clustered_trimmed`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Union

import torch

from . import coreset as coreset_ops
from . import cuda_bounds
from . import distance_field as df_ops
from . import geometry as geo
from . import nn as nn_ops


@dataclasses.dataclass(frozen=True)
class ProxyBackend:
    """Exact NN against a proxy coreset of the target.  Distances here are
    always exact f32 differences, so the JAX backend's ranking slack
    (`eps_rank`, for reduced-precision matmul ranking) has no counterpart:
    the lower-bound slack is the covering radius alone."""
    coreset: coreset_ops.ProxyCoreset

    @functools.cached_property
    def buckets(self) -> cuda_bounds.ProxyBuckets:
        """The coreset's points as the proxy bound kernels search them
        (`cuda_bounds.proxy_buckets`), built on first use."""
        return cuda_bounds.proxy_buckets(self.coreset.points.contiguous())


@dataclasses.dataclass(frozen=True)
class LutBackend:
    """Distance-field lookups.  conservative folds the field's error model
    into the estimates so lb <= true SSE stays valid; ref_compat marks a
    builder="ref" field (the reference's LUT, no guarantee); lookup is
    "nearest" (one gather per query) or "trilinear" (eight, the reference's
    texture filtering), whose worst-case errors are the same."""
    field: df_ops.DistanceField
    conservative: bool = True
    ref_compat: bool = False
    lookup: str = "nearest"

    @property
    def interp_slack(self):
        """Interpolation error bound of a 1-Lipschitz field, (sqrt(3)/2) *
        res: |interp - f(q)| <= sum_i w_i ||q - c_i||, whose square is at
        most sum_a f_a (1 - f_a) <= 3/4 cells^2 by Jensen."""
        return (geo.SQRT3 / 2.0) / self.field.inv_res


Backend = Union[ProxyBackend, LutBackend]


def make_backend(target: torch.Tensor, kind: str = "proxy",
                 proxy_size: int = 4096, seed: int = 0,
                 field: Optional[df_ops.DistanceField] = None,
                 conservative: bool = True, ref_compat: bool = False,
                 lookup: str = "auto") -> Backend:
    """Build a distance backend over the (normalized) target cloud."""
    if kind == "proxy":
        return ProxyBackend(
            coreset=coreset_ops.build(target, size=proxy_size, seed=seed))
    if kind == "exact":
        return ProxyBackend(coreset=coreset_ops.ProxyCoreset(
            points=target, eps=torch.zeros((), dtype=torch.float32,
                                           device=target.device)))
    if kind == "lut":
        if field is None:
            raise ValueError("the lut backend needs a built DistanceField")
        cons = conservative and not ref_compat
        if lookup == "auto":
            # The single-gather form when the slack is folded anyway; the
            # reference's trilinear filtering for raw lookups.
            lookup = "nearest" if cons else "trilinear"
        if lookup not in ("nearest", "trilinear"):
            raise ValueError(f"Unknown lut lookup mode: {lookup!r}")
        return LutBackend(field=field, conservative=cons,
                          ref_compat=ref_compat, lookup=lookup)
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


def distance_estimates(backend: Backend, queries: torch.Tensor):
    """(d_ub, d_lb) per query [..., 3]: d_lb <= d_target(q) <= d_ub."""
    if isinstance(backend, ProxyBackend):
        shape = queries.shape[:-1]
        d2 = nn_ops.nearest_sqdist(queries, backend.coreset.points)
        d = torch.sqrt(torch.clamp(d2, min=0.0)).reshape(shape)
        return d, d - backend.coreset.eps
    if not isinstance(backend, LutBackend):
        raise TypeError(f"Unknown backend type: {type(backend)}")
    field = backend.field
    if backend.ref_compat:
        d = df_ops.lookup_ref_compat(field, queries)
        return d, d  # the reference's raw lookup, no slack
    d = (df_ops.lookup_nearest(field, queries) if backend.lookup == "nearest"
         else df_ops.lookup(field, queries))
    if not backend.conservative:
        return d, d
    # Asymmetric per-lookup bracket (DistanceField error model): with stored
    # node value s, lookup L at the clamped query q_c, quantization
    # |quantized - s| <= qe * s, interpolation error <= iota and the EDT
    # seeding bracket d(q_c) - delta <= s <= sqrt((d(q_c)+delta)^2+delta^2),
    #   d(q_c) <= L/(1-qe) + iota + delta,
    #   d(q_c) >= relu(sqrt(relu((L/(1+qe) - iota)^2 - delta^2)) - delta).
    # Out-of-box queries (exc = box_excess > 0) extend it to q itself:
    # d(q) <= d(q_c) + exc and d(q)^2 >= d(q_c)^2 + exc^2.
    qe, delta = field.quant_eps, field.assign_delta
    iota = backend.interp_slack
    exc = df_ops.box_excess(field, queries)
    s_up = d / (1.0 - qe) + iota
    s_lo = torch.clamp(d / (1.0 + qe) - iota, min=0.0)
    d_ub = s_up + delta + exc
    lb_c = torch.clamp(
        torch.sqrt(torch.clamp(s_lo ** 2 - delta ** 2, min=0.0)) - delta,
        min=0.0)
    return d_ub, torch.sqrt(lb_c ** 2 + exc ** 2)


def _no_points_axis(points_axis):
    if points_axis is not None:
        raise NotImplementedError(
            "point-sharded bounds (points_axis) are ROADMAP Queue 1 item 16 "
            "(multi-GPU)")


def reduce_point_terms(pt: torch.Tensor, point_weights, trim_keep,
                       points_axis=None, trim_ns: Optional[int] = None,
                       drop_mode: str = "exact") -> torch.Tensor:
    """Reduce per-point bound terms [..., ns] to per-node sums.

    point_weights [ns] multiply the terms (0/1 padding masks with trimming).
    With trim_keep, the n_drop = trim_ns - trim_keep largest weighted terms
    are left out (trim_ns defaults to ns): exactly (`drop_mode="exact"`,
    top-k) or by the bisection bracket (`cuda_bounds.dropsum_bracket`),
    "over" for lower-bound terms (the lb stays sound) and "under" for
    upper-bound terms (the ub stays valid).  Weight-0 points are masked
    with -BIG so they are never dropped."""
    _no_points_axis(points_axis)
    if point_weights is not None:
        w = torch.broadcast_to(point_weights.to(torch.float32),
                               pt.shape[-1:])
        pt = pt * w
        masked = torch.where(w > 0, pt, -nn_ops.BIG)
    else:
        masked = pt
    total = torch.sum(pt, dim=-1)
    if trim_keep is None:
        return total
    n_drop = (trim_ns if trim_ns is not None else pt.shape[-1]) - trim_keep
    if n_drop <= 0:
        return total
    if drop_mode != "exact":
        drop = cuda_bounds.dropsum_bracket(masked, n_drop, drop_mode)
        return total - torch.clamp(drop, min=0.0)
    top = torch.topk(masked, min(n_drop, pt.shape[-1]), dim=-1).values
    return total - torch.sum(torch.clamp(top, min=0.0), dim=-1)


def _weighted_drop_sum(values: torch.Tensor, weights: torch.Tensor,
                       n_drop: int) -> torch.Tensor:
    """Greedy maximum total of n_drop member terms, where cluster j holds
    weights[j] members each contributing values[j] (values [..., K],
    weights [K] or [..., K]): clusters by value descending, members taken
    until the budget is spent.  The sort is stable, as `jnp.argsort`."""
    w = torch.broadcast_to(weights.to(torch.float32), values.shape)
    order = torch.argsort(-values, dim=-1, stable=True)
    v = torch.take_along_dim(values, order, dim=-1)
    w = torch.take_along_dim(w, order, dim=-1)
    cum = torch.cumsum(w, dim=-1)
    take = torch.clamp(float(n_drop) - (cum - w), min=torch.zeros_like(w),
                       max=w)
    return torch.sum(v * take, dim=-1)


def reduce_clustered_trimmed(lb_pt: torch.Tensor, ub_pt: torch.Tensor,
                             point_weights: torch.Tensor, trim_keep: int,
                             trim_ns: int, points_axis=None):
    """Trimmed bounds over weighted source clusters: with member-level
    brackets lb_j <= true_j <= ub_j,
        lb = max(sum w*lb - greedy top-n_drop of member UB terms, 0)
        ub = sum w*ub - greedy top-n_drop of member LB terms
    are valid trimmed bounds (fgoicp_tpu/ops/bounds.py's derivation).
    Returns (lb, ub)."""
    _no_points_axis(points_axis)
    w = point_weights.to(torch.float32)
    total_lb = torch.sum(lb_pt * w, dim=-1)
    total_ub = torch.sum(ub_pt * w, dim=-1)
    n_drop = trim_ns - trim_keep
    if n_drop <= 0:
        return total_lb, total_ub
    lb = torch.clamp(total_lb - _weighted_drop_sum(ub_pt, w, n_drop),
                     min=0.0)
    ub = total_ub - _weighted_drop_sum(lb_pt, w, n_drop)
    return lb, ub


def point_terms(backend: Backend, q: torch.Tensor, gam_ub, gam_lb,
                gam_t):
    """Unweighted per-point terms (lb_pt, ub_pt) for queries q [..., ns, 3]
    with radii broadcasting against [..., ns] (gam_t against [...])."""
    d_ub, d_lb = distance_estimates(backend, q)
    ub_pt = torch.square(torch.clamp(d_ub - gam_ub, min=0.0))
    lb_pt = torch.square(torch.clamp(d_lb - gam_lb - gam_t[..., None],
                                     min=0.0))
    return lb_pt, ub_pt


def evaluate_bounds(backend: Backend, pcs: torch.Tensor,
                    R: torch.Tensor, rot_spans: torch.Tensor,
                    fix_rot: torch.Tensor, t_centers: torch.Tensor,
                    t_spans: torch.Tensor, node_mask=None,
                    ref_compat_gamma: bool = False,
                    trim_keep: Optional[int] = None, points_axis=None,
                    point_weights=None, point_deltas=None,
                    trim_ns: Optional[int] = None, point_order=None):
    """lb, ub [G, B] for a grid of (rotation group, translation node)s.

    pcs [ns, 3]; R [G, 3, 3]; rot_spans [G]; fix_rot [G] bool (gamma_r off);
    t_centers [G, B, 3]; t_spans [G, B]; node_mask [G, B] bool (False nodes
    return BIG).  point_weights [ns] multiply both terms (a 0/1 mask with
    trimming); point_deltas [ns] are source-cluster radii (with trim_keep
    they select the member-level clustered trim, which needs point_weights
    and trim_ns).  Untrimmed proxy nodes go through the fused grid kernel
    (`cuda_bounds.fused_bounds`); trimmed ones through the nearest-proxy
    kernel and the torch reductions, and LUT nodes through the field
    lookups and the torch reductions, as the JAX package does.
    point_order: the grid kernel's `cuda_bounds.source_order` of pcs."""
    _no_points_axis(points_axis)
    clustered_trim = trim_keep is not None and point_deltas is not None
    if clustered_trim and (point_weights is None or trim_ns is None):
        raise ValueError(
            "clustered trimming needs point_weights (member counts) and "
            "trim_ns (global member count)")
    if not isinstance(backend, (ProxyBackend, LutBackend)):
        raise TypeError(f"Unknown backend type: {type(backend)}")
    norms = torch.linalg.vector_norm(pcs, dim=-1)
    gam_ub, gam_lb = gamma_arrays(norms, rot_spans, fix_rot,
                                  ref_compat=ref_compat_gamma,
                                  point_deltas=point_deltas)
    gam_t = geo.translation_uncertainty_radius(t_spans)         # [G, B]
    base = torch.einsum("grc,nc->gnr", R, pcs)                  # [G, ns, 3]
    if trim_keep is None and isinstance(backend, ProxyBackend):
        lb, ub = cuda_bounds.fused_bounds(
            base.contiguous(), t_centers.contiguous(), backend.buckets,
            gam_ub.contiguous(),
            gam_t.contiguous(), float(backend.coreset.eps),
            point_weights=(None if point_weights is None
                           else point_weights.contiguous()),
            gam_lb=gam_lb.contiguous(), point_order=point_order)
    else:
        q = base[:, None, :, :] + t_centers[:, :, None, :]      # [G, B, ns, 3]
        lb_pt, ub_pt = point_terms(backend, q, gam_ub[:, None, :],
                                   gam_lb[:, None, :], gam_t)
        if clustered_trim:
            lb, ub = reduce_clustered_trimmed(lb_pt, ub_pt, point_weights,
                                              trim_keep, trim_ns)
        else:
            ub = reduce_point_terms(ub_pt, point_weights, trim_keep,
                                    trim_ns=trim_ns, drop_mode="under")
            lb = reduce_point_terms(lb_pt, point_weights, trim_keep,
                                    trim_ns=trim_ns, drop_mode="over")
    if node_mask is not None:
        lb = torch.where(node_mask, lb, nn_ops.BIG)
        ub = torch.where(node_mask, ub, nn_ops.BIG)
    return lb, ub
