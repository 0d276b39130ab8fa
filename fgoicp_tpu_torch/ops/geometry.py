"""SE(3) search-space geometry: quaternion-cube rotations, SO(3) tests,
octree node splitting, cloud normalization.

Torch counterpart of `fgoicp_tpu/ops/geometry.py`, with the same formulas
in the same evaluation order so that float32 results agree elementwise.
Math parity with the reference (fgoicp/common.hpp:30-128,
fgoicp.cpp:176-287), written as batched tensor functions so whole frontiers
of nodes are processed at once.

Convention note: the reference stores its quaternion matrix through glm's
column-major constructor, so it applies R(q)^T = R(q^{-1}).  The quaternion
cube is symmetric under q -> q^{-1}, so the searched rotation set is the
same; like the JAX package, this uses the standard R(q).
"""

from __future__ import annotations

import math

import numpy as np
import torch

SQRT3 = 1.7320508075688772


def quat_cube_to_matrix(xyz: torch.Tensor) -> torch.Tensor:
    """Map quaternion-imaginary cube coordinates [..., 3] to rotation
    matrices [..., 3, 3].

    w = sqrt(max(1 - |xyz|^2, 0)); coordinates outside the unit ball give a
    best-effort matrix (callers mask by `in_so3`).  Reference:
    common.hpp:37-57.
    """
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    r2 = x * x + y * y + z * z
    ww = torch.clamp(1.0 - r2, min=0.0)
    w = torch.sqrt(ww)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = torch.stack([ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)], dim=-1)
    row1 = torch.stack([2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)], dim=-1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def in_so3(xyz: torch.Tensor) -> torch.Tensor:
    """Cube coordinate lies inside the closed unit ball (common.hpp:68)."""
    return torch.sum(xyz * xyz, dim=-1) <= 1.0


def overlaps_so3(xyz: torch.Tensor, span) -> torch.Tensor:
    """Conservative cube-vs-unit-ball overlap test:
    (|x|-s)^2 + (|y|-s)^2 + (|z|-s)^2 <= 1, expanded with the squared
    center norm (see the JAX package's note on the reference's variant)."""
    r2 = torch.sum(xyz * xyz, dim=-1)
    abs_sum = torch.sum(torch.abs(xyz), dim=-1)
    return r2 - 2.0 * span * abs_sum + 3.0 * span * span <= 1.0


# Child-offset signs for octree splitting: child j's center is
# parent +- span/2 per axis by the bit pattern of j (fgoicp.cpp:54-59).
_CHILD_SIGNS = np.array(
    [[(j >> 0) & 1, (j >> 1) & 1, (j >> 2) & 1] for j in range(8)],
    dtype=np.float32,
) * 2.0 - 1.0  # [8, 3] in {-1, +1}


def split_octree(centers: torch.Tensor, spans: torch.Tensor):
    """Split nodes [..., 3] with half-spans [...] into 8 children.

    Returns (child_centers [..., 8, 3], child_spans [..., 8]).
    """
    signs = torch.as_tensor(_CHILD_SIGNS, device=centers.device)
    half = spans[..., None] * 0.5
    child_centers = centers[..., None, :] + signs * half[..., None]
    child_spans = (spans * 0.5)[..., None].expand(child_centers.shape[:-1])
    return child_centers, child_spans


def rotation_uncertainty_radius(point_norms, span, ref_compat: bool = False):
    """Per-point rotation uncertainty radius gamma_r for a rotation cube of
    half-span `span`: 2 * sin(min(half_angle, pi/2)) * |p| with
    half_angle = span * sqrt(3) * pi / 2 (Go-ICP paper, eq. 6).
    ref_compat reproduces the reference's variant (registration.cu:39-43):
    squared norm, no clamp."""
    half_angle = span * SQRT3 * (math.pi / 2.0)
    if ref_compat:
        return 2.0 * (point_norms * point_norms) * torch.sin(half_angle)
    return 2.0 * point_norms * torch.sin(
        torch.clamp(half_angle, max=math.pi / 2.0))


def translation_uncertainty_radius(span):
    """gamma_t = sqrt(3) * span (registration.cu:33)."""
    return SQRT3 * span


def multi_start_cube_coords() -> np.ndarray:
    """Quaternion-cube coordinates of the 14 non-identity ICP seed starts:
    the 8 rotation-cube octant centers plus the 6 face centers (the ±90°
    rotations about each axis)."""
    octants = [[sx * 0.5, sy * 0.5, sz * 0.5]
               for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    r = 1.0 / np.sqrt(2.0)  # quaternion cube coordinate of a 90° turn
    faces = [[s * r if a == ax else 0.0 for a in range(3)]
             for ax in range(3) for s in (-1, 1)]
    return np.asarray(octants + faces, np.float32)


def multi_start_rotations(include_identity: bool = True) -> np.ndarray:
    """[S, 3, 3] float32 seed rotation matrices for the multi-start sweeps
    (identity first when included)."""
    R = quat_cube_to_matrix(
        torch.from_numpy(multi_start_cube_coords())).numpy()
    if include_identity:
        R = np.concatenate([np.eye(3, dtype=np.float32)[None], R])
    return R


# ---------------------------------------------------------------------------
# Cloud normalization (fgoicp.cpp:176-287, fgoicp.hpp:87-90)
# ---------------------------------------------------------------------------


def center_cloud(pc: torch.Tensor):
    """Subtract centroid; return (centered, offset=-centroid)."""
    centroid = torch.mean(pc, dim=0)
    return pc - centroid, -centroid


def source_scaling_factor(pcs: torch.Tensor) -> torch.Tensor:
    """1 / max absolute coordinate of the (centered) source cloud."""
    return 1.0 / torch.max(torch.abs(pcs))


def cloud_ranges(pc: torch.Tensor) -> torch.Tensor:
    """Per-axis (min, max) of a cloud -> [3, 2]."""
    return torch.stack([torch.amin(pc, dim=0), torch.amax(pc, dim=0)], dim=-1)


class Normalization:
    """Centering + source-max scaling applied to both clouds, and the
    inverse map for the final translation (fgoicp.hpp:87-90).

    Takes float32 [N, 3] tensors (any device); every result lives there."""

    def __init__(self, pct: torch.Tensor, pcs: torch.Tensor):
        pct_c, self.offset_pct = center_cloud(pct)
        pcs_c, self.offset_pcs = center_cloud(pcs)
        self.scale = source_scaling_factor(pcs_c)
        self.pct = pct_c * self.scale
        self.pcs = pcs_c * self.scale
        self.target_bounds = cloud_ranges(self.pct)

    def restore_translation(self, R: torch.Tensor, t: torch.Tensor):
        """t_world = t/scale + R @ offset_pcs - offset_pct."""
        return t / self.scale + R @ self.offset_pcs - self.offset_pct
