"""Batched Procrustes alignment (Kabsch) without an SVD.

Counterpart of `fgoicp_tpu/ops/procrustes.py`: the same determinant-scaled
Newton polar iteration and the same reflection fix, so that both packages
agree also on rank-2 correspondences (a general SVD would pick other
singular vectors there).  The fix is keyed on the polar factor's
determinant (see closest_rotation), which differs from the JAX package
only on rank-1 input, where that package can return a reflection.  Parity with the reference's
IterativeClosestPoint3D::procrustes (icp3d.cu:110-172).

`torch.linalg.inv_ex` is used instead of `torch.linalg.inv` so that no
error check waits for the device.
"""

from __future__ import annotations

import torch


def _polar_orthogonal(m: torch.Tensor, iters: int = 9) -> torch.Tensor:
    """Orthogonal polar factor of [..., 3, 3] via determinant-scaled Newton
    iteration X <- (z X + (z X)^-T) / 2, z = |det X|^(-1/3).

    Quadratically convergent and accurate in float32; the determinant
    scaling makes convergence nearly independent of conditioning.
    """
    norm = torch.linalg.matrix_norm(m, keepdim=True)
    x = m / torch.clamp(norm, min=1e-30)
    # Guard rank-deficient inputs (degenerate correspondences) with a ridge
    # so the inverse stays finite; the result is still orthogonal.
    det = torch.linalg.det(x)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    x = torch.where((torch.abs(det) < 1e-6)[..., None, None], x + 1e-3 * eye, x)
    for _ in range(iters):
        det = torch.abs(torch.linalg.det(x))
        z = torch.clamp(det, min=1e-12) ** (-1.0 / 3.0)
        z = torch.clamp(z, 1e-3, 1e6)[..., None, None]
        zx = z * x
        xit = torch.linalg.inv_ex(zx).inverse.transpose(-1, -2)
        x = 0.5 * (zx + xit)
    return x


def _smallest_eigvec_sym3(a: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric [..., 3, 3]."""
    _, v = torch.linalg.eigh(a)  # ascending eigenvalues
    return v[..., :, 0]


def closest_rotation(abt: torch.Tensor) -> torch.Tensor:
    """Closest rotation (det=+1) to cross-covariance matrices [..., 3, 3].

    R is the orthogonal polar factor Q of M = ABt^T; when Q is a reflection
    the proper-rotation fix R <- Q (I - 2 v3 v3^T) applies, with v3 the
    smallest right-singular direction of M (the reference's JacobiSVD +
    det(VU^T) fix, icp3d.cu:110-138).

    The fix is keyed on det(Q), which is +-1, where the JAX package keys it
    on det(M).  The two agree wherever det(M) is not rounding noise (the
    polar factor of a full-rank M has the sign of det(M)); on exactly
    rank-1 correspondences the sign of det(M) is noise and the JAX key can
    return a reflection (ROADMAP Queue 3), which this key never does.
    """
    m = abt.transpose(-1, -2)
    q = _polar_orthogonal(m)
    v3 = _smallest_eigvec_sym3(m.transpose(-1, -2) @ m)
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    refl = eye - 2.0 * v3[..., :, None] * v3[..., None, :]
    q_fixed = q @ refl
    return torch.where((torch.linalg.det(q) < 0)[..., None, None], q_fixed, q)


def procrustes(src: torch.Tensor, corr: torch.Tensor, mask=None):
    """Best rigid motion mapping src -> corr (both [..., N, 3]).

    Returns (R [..., 3, 3], t [..., 3]) with corr ~= R @ src + t.  `mask`
    ([..., N]) optionally weights the points (icp3d.cu:140-172).
    """
    if mask is None:
        w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    else:
        w = mask.to(src.dtype)
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)
    mu_s = torch.sum(src * w[..., None], dim=-2) / wsum
    mu_c = torch.sum(corr * w[..., None], dim=-2) / wsum
    a = (src - mu_s[..., None, :]) * w[..., None]
    b = corr - mu_c[..., None, :]
    # ABt[r, c] = sum_i a_i[r] * b_i[c]: R minimizes ||R a - b||.
    abt = torch.einsum("...nr,...nc->...rc", a, b)
    r = closest_rotation(abt)
    t = mu_c - torch.einsum("...rc,...c->...r", r, mu_s)
    return r, t
