"""Dense 3D nearest-neighbour distance field with trilinear and nearest-node
lookup: the LUT bound backend's field.

Counterpart of `fgoicp_tpu/ops/distance_field.py` (capability parity with
the reference's NearestNeighborLUT, registration.cu:180-328), with the same
formulas in the same order:

* a voxel grid over the (normalized) target box at `resolution`,
  dims = ceil(range / res) + 1 nodes per axis, node i at origin + i * res;
* stored quantity: the distance d (not d^2), queried by nearest-node or
  trilinear lookup with border clamping, plus `box_excess` for queries
  outside the box;
* builders: `brute` (exact, zero slack; `nn.nearest_sqdist` from every grid
  node, so the `nn_min` kernel on the card), `edt` (each target point seeds
  its nearest node with its exact squared distance, then three 1-D min-plus
  passes along z, y and x, the `minplus_1d` kernel of
  `ops/cuda_minplus.py` on the card), which brackets the true d as
      d - delta <= stored <= sqrt((d + delta)^2 + delta^2),
  delta = (sqrt(3)/2) * res (node error <= sqrt(3/2) * res), and `ref`
  (the reference's squared-distance field with no +1 node, read only
  through `lookup_ref_compat`, which carries no validity guarantee);
* narrow storage (bfloat16 / float16) records its relative rounding bound
  in `quant_eps`, applied per lookup by `bounds.distance_estimates`.

Memory: the EDT keeps at most two float32 copies of the grid alive (a
pass's input and output; each input is released before the next permute
copy) plus the storage copy, which is what `check_memory_budget` assumes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from . import cuda_minplus
from . import nn as nn_ops
from ..utils import logging as log

BIG = 1e10


@dataclasses.dataclass(frozen=True)
class DistanceField:
    """Dense distance grid + affine query mapping.

    Error model (consumed by bounds.distance_estimates): with true NN
    distance d and stored node value s,
        d - assign_delta <= s <= sqrt((d + assign_delta)^2 + assign_delta^2)
    (0 for the exact brute builder), and the narrowed value qv satisfies
    |qv - s| <= quant_eps * s (0 for float32).
    """

    values: torch.Tensor        # [X, Y, Z] distances (dtype configurable)
    origin: torch.Tensor        # [3] world position of grid node (0, 0, 0)
    inv_res: torch.Tensor       # 0-d 1 / resolution
    assign_delta: torch.Tensor  # 0-d EDT seeding radius (0 = exact)
    quant_eps: torch.Tensor     # 0-d relative storage rounding bound
    # The builder that made `values` ("brute", "edt" or "ref"); None for a
    # field carried across with `field_from_numpy`.
    builder: Optional[str] = None

    @property
    def dims(self):
        return tuple(self.values.shape)

    @property
    def slack(self):
        """Absolute node-value error bound |stored - true| (float32 fields):
        sqrt(2) * delta, the upper bracket's peak at d = 0."""
        return math.sqrt(2.0) * self.assign_delta


def field_from_numpy(values, origin, inv_res, assign_delta, quant_eps,
                     device) -> DistanceField:
    """A field from numpy arrays, e.g. the JAX package's built field, so
    lookups, bounds and searches can run both packages on the same grid.
    `values` keep their dtype (bfloat16 arrives as ml_dtypes bfloat16)."""
    v = np.asarray(values)
    if v.dtype.name == "bfloat16":  # exact through float32
        vals = torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
    else:
        vals = torch.from_numpy(v.copy())

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return DistanceField(values=vals.to(device), origin=f32(origin),
                         inv_res=f32(inv_res), assign_delta=f32(assign_delta),
                         quant_eps=f32(quant_eps))


def grid_dims(bounds, resolution, max_dim=2048, warn_dim=1024,
              inclusive=True):
    """dims = ceil(range / res) + 1 nodes per axis (inclusive=False: the
    reference's ceil(range / res), registration.cu:186-188).  Hard error at
    max_dim, warning at warn_dim (registration.cu:191-198), and a refusal at
    2^31 cells, where flat int32 gather indices would wrap."""
    bounds = np.asarray(bounds, np.float64)
    extra = 1 if inclusive else 0
    dims = tuple(
        int(math.ceil((bounds[a, 1] - bounds[a, 0]) / resolution)) + extra
        for a in range(3))
    dims = tuple(max(d, 2) for d in dims)
    if any(d >= max_dim for d in dims):
        raise ValueError(
            f"Distance-field dims {dims} exceed the limit {max_dim}; "
            f"increase lut_resolution")
    if int(np.prod(dims)) >= 2 ** 31:
        raise ValueError(
            f"Distance-field dims {dims} exceed 2^31 cells (int32 gather "
            f"index range); use a coarser lut_resolution")
    if any(d >= warn_dim for d in dims):
        log.warning(f"Distance-field dims {dims} are large; consider a "
                    "coarser lut_resolution")
    return dims


def device_memory_budget(device=None, default: int = 16 * 1024**3) -> int:
    """Bytes of the device's memory: the card's total on CUDA
    (`torch.cuda.mem_get_info`), else `default` (the JAX package's 16 GiB
    fallback, so both packages refuse the same fields on the CPU)."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[1])
    return default


def check_memory_budget(dims, dtype, builder: str,
                        hbm_budget: Optional[int] = None, device=None):
    """Refuse field builds that cannot fit device memory; returns the
    estimated peak bytes.  EDT: two live float32 copies of the grid plus the
    storage copy; brute and ref: one float32 copy plus storage."""
    n_cells = int(np.prod(dims))
    store = n_cells * dtype.itemsize
    f32_copies = 1 if builder in ("brute", "ref") else 2
    peak = n_cells * 4 * f32_copies + store
    budget = (hbm_budget if hbm_budget is not None
              else device_memory_budget(device))
    # Headroom for clouds, bound-evaluation buffers and fragmentation.
    usable = int(budget * 0.85)
    if peak > usable:
        raise ValueError(
            f"Distance field dims {tuple(dims)} needs ~{peak / 1e9:.1f} GB "
            f"to build (budget {usable / 1e9:.1f} GB): use a coarser "
            f"lut_resolution or a narrower lut_dtype (bfloat16 halves "
            f"storage)")
    return peak


def _nearest_node_idx(points, origin, inv_res, dims):
    """Clipped nearest-grid-node index [..., 3] (int64) for world points.
    The EDT seeding and `lookup_nearest` share it: the assign_delta bracket
    assumes both snap points to nodes identically."""
    x, y, z = dims
    c = (points.to(torch.float32) - origin) * inv_res
    hi = torch.tensor([x - 1, y - 1, z - 1], dtype=torch.int64,
                      device=c.device)
    return torch.clamp(torch.round(c).to(torch.int64), min=torch.zeros_like(hi),
                       max=hi)


def _flat_index(idx, dims):
    _, y, z = dims
    return (idx[..., 0] * y + idx[..., 1]) * z + idx[..., 2]


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


def _build_brute(points, origin, res, dims, cell_chunk=32768,
                 squared=False):
    """Exact min distance from every grid node to the cloud, `cell_chunk`
    nodes at a time (squared=True keeps d^2, the reference's quantity).
    Returns float32 [X, Y, Z]."""
    x, y, z = dims
    n_cells = x * y * z
    vals = torch.empty(n_cells, dtype=torch.float32, device=points.device)
    for s in range(0, n_cells, cell_chunk):
        lin = torch.arange(s, min(s + cell_chunk, n_cells),
                           device=points.device)
        coords = torch.stack([lin // (z * y), (lin // z) % y, lin % z],
                             dim=-1).to(torch.float32)
        pos = origin[None, :] + coords * res
        vals[s:s + cell_chunk] = nn_ops.nearest_sqdist(pos, points)
    vals.clamp_(min=0.0)
    if not squared:
        vals.sqrt_()
    return vals.reshape(dims)


def _seed_grid(points, origin, res, dims):
    """The EDT's seeded float32 grid [X, Y, Z]: BIG everywhere, and at each
    point's nearest node the least squared distance of a point to it
    (scatter-min)."""
    x, y, z = dims
    idx = _nearest_node_idx(points, origin[None, :], 1.0 / res, dims)
    d = points - (origin[None, :] + idx.to(torch.float32) * res)
    d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    f = torch.full((x * y * z,), BIG, dtype=torch.float32,
                   device=points.device)
    f.scatter_reduce_(0, _flat_index(idx, dims), d2, reduce="amin")
    return f.reshape(dims)


def _build_edt(points, origin, res, dims):
    """Generalized exact EDT from point-seeded grid nodes (module doc).
    Min-plus passes commute only in exact arithmetic, so the order is the
    JAX package's: z, then y after a cyclic permute, then x."""
    x, y, z = dims
    r = float(res)
    f = _seed_grid(points, origin, res, dims)
    # The 1-D passes run the `minplus_1d` kernel on the card and its plain
    # version on the CPU.  Each pass's input is dropped as its output is
    # made, and each permute copy replaces the pass output it came from: at
    # most two float32 grids are alive at once.
    f = cuda_minplus.minplus_1d(f.reshape(x * y, z), r).reshape(x, y, z)
    f = f.permute(2, 0, 1).contiguous()                          # [Z, X, Y]
    f = cuda_minplus.minplus_1d(f.reshape(z * x, y), r).reshape(z, x, y)
    f = f.permute(2, 0, 1).contiguous()                          # [Y, Z, X]
    f = cuda_minplus.minplus_1d(f.reshape(y * z, x), r).reshape(y, z, x)
    f = f.permute(2, 0, 1).contiguous()                          # [X, Y, Z]
    # sqrt(max(f, 0)) in place, before the storage cast, so no third float32
    # grid is allocated.
    return f.clamp_(min=0.0).sqrt_()


_QUANT_EPS = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}


def build(points, bounds, resolution, builder: str = "auto",
          dtype=torch.float32, max_dim: int = 2048, warn_dim: int = 1024,
          brute_budget: float = 2.0e11,
          hbm_budget: Optional[int] = None) -> DistanceField:
    """Construct the distance field over `bounds` ([3, 2] min/max) on the
    device of `points` [N, 3].

    builder: 'brute' (exact), 'edt' (node error <= sqrt(3/2) * res), 'auto'
    (brute iff cells * n_points <= brute_budget), or 'ref' (the reference's
    d^2 field; read it only through lookup_ref_compat).  Narrow dtypes record
    their relative rounding bound in `quant_eps` (the `slack` property
    covers the builder error only)."""
    points = points.to(torch.float32)
    if isinstance(bounds, torch.Tensor):
        bounds = bounds.detach().cpu().numpy()
    bounds = np.asarray(bounds, np.float64)
    inclusive = builder != "ref"  # ref: ceil(range / res), no +1 node
    dims = grid_dims(bounds, resolution, max_dim=max_dim, warn_dim=warn_dim,
                     inclusive=inclusive)
    dev = points.device
    origin = torch.tensor(bounds[:, 0], dtype=torch.float32, device=dev)
    res = torch.tensor(resolution, dtype=torch.float32, device=dev)
    n_cells = int(np.prod(dims))
    if builder == "auto":
        builder = ("brute" if n_cells * points.shape[0] <= brute_budget
                   else "edt")
    check_memory_budget(dims, dtype, builder, hbm_budget=hbm_budget,
                        device=dev)
    log.debug(f"Building distance field dims={dims} builder={builder}")
    if builder == "brute":
        vals = _build_brute(points, origin, res, dims)
        delta = 0.0
    elif builder == "edt":
        # Each point seeds its nearest node: assignment radius = half the
        # cell diagonal.
        delta = (math.sqrt(3.0) / 2.0) * resolution
        vals = _build_edt(points, origin, res, dims)
    elif builder == "ref":
        vals = _build_brute(points, origin, res, dims, squared=True)
        delta = 0.0  # no guarantee in compat mode (module doc)
    else:
        raise ValueError(f"Unknown distance-field builder: {builder}")
    vals = vals.to(dtype)
    quant_eps = 0.0 if builder == "ref" else _QUANT_EPS.get(dtype, 0.0)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    return DistanceField(values=vals, origin=origin,
                         inv_res=f32(1.0 / resolution),
                         assign_delta=f32(delta), quant_eps=f32(quant_eps),
                         builder=builder)


# ---------------------------------------------------------------------------
# Lookup
# ---------------------------------------------------------------------------


def _trilinear(field: DistanceField, c):
    """Trilinear interpolation of stored values at grid coords c [..., 3]
    (already mapped / shifted); coordinates clamp to the border like
    cudaAddressModeClamp (registration.cu:226-228)."""
    x, y, z = field.values.shape
    dev = c.device
    c = torch.clamp(c, min=torch.zeros(3, device=dev),
                    max=torch.tensor([x - 1, y - 1, z - 1],
                                     dtype=torch.float32, device=dev))
    i0 = torch.minimum(c.to(torch.int64),
                       torch.tensor([x - 2, y - 2, z - 2], device=dev))
    i0 = torch.clamp(i0, min=0)
    frac = c - i0.to(torch.float32)
    flat = field.values.reshape(-1)
    ix, iy, iz = i0[..., 0], i0[..., 1], i0[..., 2]
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]

    def fetch(dx, dy, dz):
        lin = ((ix + dx) * y + (iy + dy)) * z + (iz + dz)
        return flat[torch.clamp(lin, 0, flat.shape[0] - 1)].to(torch.float32)

    # Lerp over z, then y, then x.
    c00 = fetch(0, 0, 0) * (1 - fz) + fetch(0, 0, 1) * fz
    c01 = fetch(0, 1, 0) * (1 - fz) + fetch(0, 1, 1) * fz
    c10 = fetch(1, 0, 0) * (1 - fz) + fetch(1, 0, 1) * fz
    c11 = fetch(1, 1, 0) * (1 - fz) + fetch(1, 1, 1) * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


def lookup(field: DistanceField, queries):
    """Trilinear distance lookup for queries [..., 3] (world coordinates).
    Out-of-box queries clamp to the border; callers needing valid estimates
    at the query itself fold in `box_excess` (bounds.distance_estimates)."""
    q = queries.to(torch.float32)
    return _trilinear(field, (q - field.origin) * field.inv_res)


def lookup_nearest(field: DistanceField, queries):
    """Nearest-grid-node lookup: one gather per query.  For the 1-Lipschitz
    stored field its worst-case error bound equals trilinear's,
    (sqrt(3)/2) * res.  Out-of-box queries clamp like `lookup`."""
    idx = _nearest_node_idx(queries, field.origin, field.inv_res,
                            field.values.shape)
    return field.values.reshape(-1)[
        _flat_index(idx, field.values.shape)].to(torch.float32)


def box_excess(field: DistanceField, queries):
    """Euclidean distance from each query to the field's node box (0 in the
    box).  The target lies inside the box, so with q_c = clamp(q):
    d(q) <= d(q_c) + excess and d(q)^2 >= d(q_c)^2 + excess^2."""
    q = queries.to(torch.float32)
    dims = torch.tensor(field.values.shape, dtype=torch.float32,
                        device=q.device)
    hi = field.origin + (dims - 1.0) / field.inv_res
    o = torch.clamp(torch.maximum(field.origin - q, q - hi), min=0.0)
    return torch.sqrt(o[..., 0] * o[..., 0] + o[..., 1] * o[..., 1]
                      + o[..., 2] * o[..., 2])


def lookup_ref_compat(field: DistanceField, queries):
    """Reference-compat lookup on a builder="ref" d^2 field: the half-texel
    shift of tex3D linear filtering (registration.cu:320-328), trilinear on
    d^2, then sqrt."""
    q = queries.to(torch.float32)
    c = (q - field.origin) * field.inv_res - 0.5
    return torch.sqrt(torch.clamp(_trilinear(field, c), min=0.0))
