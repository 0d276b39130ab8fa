"""Port parity for the numeric building blocks: geometry (elementwise),
Procrustes (random and rank-deficient correspondences) and the coreset
builders (identical FPS indices, equal eps, weights and deltas), each fed
the same seeded numpy inputs as the JAX package."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgoicp_tpu.ops import coreset as jcoreset
from fgoicp_tpu.ops import geometry as jgeo
from fgoicp_tpu.ops import procrustes as jproc
from fgoicp_tpu_torch.ops import coreset as tcoreset
from fgoicp_tpu_torch.ops import geometry as tgeo
from fgoicp_tpu_torch.ops import procrustes as tproc


def T(a):
    """A torch tensor holding a copy of a numpy or JAX array."""
    return torch.from_numpy(np.array(a))


def _close(t, j, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(t.numpy() if torch.is_tensor(t) else t,
                               np.asarray(j), rtol=rtol, atol=atol)


# ----------------------------------------------------------------- geometry
def test_quat_cube_to_matrix_and_so3_tests():
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-1.1, 1.1, size=(200, 3)).astype(np.float32)
    _close(tgeo.quat_cube_to_matrix(T(xyz)), jgeo.quat_cube_to_matrix(xyz))
    np.testing.assert_array_equal(tgeo.in_so3(T(xyz)).numpy(),
                                  np.asarray(jgeo.in_so3(xyz)))
    for span in (0.05, 0.25, 0.5):
        np.testing.assert_array_equal(
            tgeo.overlaps_so3(T(xyz), span).numpy(),
            np.asarray(jgeo.overlaps_so3(xyz, span)))


def test_split_octree_matches():
    rng = np.random.default_rng(1)
    c = rng.uniform(-1, 1, size=(7, 3)).astype(np.float32)
    s = rng.uniform(0.1, 0.5, size=(7,)).astype(np.float32)
    cc_t, cs_t = tgeo.split_octree(T(c), T(s))
    cc_j, cs_j = jgeo.split_octree(c, s)
    np.testing.assert_array_equal(cc_t.numpy(), np.asarray(cc_j))
    np.testing.assert_array_equal(cs_t.numpy(), np.asarray(cs_j))


@pytest.mark.parametrize("ref_compat", [False, True])
def test_uncertainty_radii_match(ref_compat):
    rng = np.random.default_rng(2)
    norms = rng.uniform(0, 1.5, size=(5, 40)).astype(np.float32)
    spans = rng.uniform(0.01, 1.0, size=(5, 1)).astype(np.float32)
    _close(tgeo.rotation_uncertainty_radius(T(norms), T(spans), ref_compat),
           jgeo.rotation_uncertainty_radius(norms, spans, ref_compat))
    _close(tgeo.translation_uncertainty_radius(T(spans)),
           jgeo.translation_uncertainty_radius(spans))


def test_multi_start_rotations_match():
    for ident in (True, False):
        r_t = tgeo.multi_start_rotations(include_identity=ident)
        r_j = jgeo.multi_start_rotations(include_identity=ident)
        assert r_t.dtype == np.float32 and r_t.shape == r_j.shape
        np.testing.assert_allclose(r_t, r_j, rtol=1e-6, atol=1e-7)


def test_normalization_matches():
    rng = np.random.default_rng(3)
    pct = (rng.normal(size=(500, 3)) * 20 + 7).astype(np.float32)
    pcs = (rng.normal(size=(300, 3)) * 5 - 3).astype(np.float32)
    nt, nj = tgeo.Normalization(T(pct), T(pcs)), jgeo.Normalization(pct, pcs)
    _close(nt.pct, nj.pct, atol=1e-6)
    _close(nt.pcs, nj.pcs, atol=1e-6)
    _close(nt.scale, nj.scale)
    _close(nt.target_bounds, nj.target_bounds, atol=1e-6)
    R = jgeo.quat_cube_to_matrix(np.asarray([0.1, -0.2, 0.3], np.float32))
    t = np.asarray([0.3, 0.1, -0.2], np.float32)
    _close(nt.restore_translation(T(R), T(t)),
           nj.restore_translation(R, t), rtol=1e-5, atol=1e-4)


# --------------------------------------------------------------- procrustes
def _proc_case(kind, seed=4, g=6, n=80):
    rng = np.random.default_rng(seed)
    if kind == "random":
        src = rng.normal(size=(g, n, 3))
    elif kind == "planar":      # rank-2 covariance
        src = rng.normal(size=(g, n, 3)) * np.asarray([1.0, 1.0, 0.0])
    else:                       # collinear: rank-1 covariance
        src = rng.normal(size=(g, n, 1)) * np.asarray([0.3, -0.5, 0.8])
    xyz = rng.uniform(-0.5, 0.5, size=(g, 3)).astype(np.float32)
    R = np.asarray(jgeo.quat_cube_to_matrix(xyz))
    t = rng.uniform(-1, 1, size=(g, 1, 3))
    corr = np.einsum("grc,gnc->gnr", R, src) + t
    corr = corr + rng.normal(scale=1e-3, size=corr.shape)
    return src.astype(np.float32), corr.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "planar"])
def test_procrustes_matches(kind):
    src, corr = _proc_case(kind)
    R_j, t_j = jproc.procrustes(src, corr)
    R_t, t_t = tproc.procrustes(T(src), T(corr))
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-5)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-5)
    # Proper rotations either way.
    np.testing.assert_allclose(torch.linalg.det(R_t).numpy(), 1.0, atol=1e-5)


def test_procrustes_collinear_returns_a_proper_rotation():
    """Rank-1 correspondences leave a family of optimal rotations (any turn
    about the line) and make the sign of det(M) rounding noise.  The port
    keys its reflection fix on det of the polar factor instead, so it
    always returns a proper rotation that maps the line onto its
    correspondences (the JAX package's det(M) key can return a reflection
    here: a reference fault, not pinned by any parity test)."""
    for seed in (4, 5, 6):
        src, corr = _proc_case("collinear", seed=seed)
        R, t = (a.numpy() for a in tproc.procrustes(T(src), T(corr)))
        np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)
        mapped = np.einsum("grc,gnc->gnr", R, src) + t[:, None, :]
        assert np.abs(mapped - corr).max() < 1e-2


def test_closest_rotation_reflection_fix_matches():
    rng = np.random.default_rng(6)
    m = rng.normal(size=(10, 3, 3)).astype(np.float32)
    m[:, :, 0] *= np.sign(np.linalg.det(m))[:, None]  # det(M) > 0 ...
    m[::2, 0, :] *= -1                                # ... half flipped
    R_t = tproc.closest_rotation(T(m))
    R_j = jproc.closest_rotation(m)
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-5)
    np.testing.assert_allclose(torch.linalg.det(R_t).numpy(), 1.0, atol=1e-5)


def test_procrustes_weighted_mask_matches():
    src, corr = _proc_case("random", seed=7)
    mask = (np.random.default_rng(8).uniform(size=src.shape[:2]) > 0.3)
    R_j, t_j = jproc.procrustes(src, corr, mask=mask.astype(np.float32))
    R_t, t_t = tproc.procrustes(T(src), T(corr), mask=T(mask))
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-5)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-5)


# ------------------------------------------------------------------ coreset
def _cloud(seed, n):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.0, 4.5, size=(n,))
    pts = np.stack([np.cos(s), 0.7 * np.sin(2.0 * s),
                    0.4 * np.sin(3.0 * s + 0.5)], axis=1)
    return (pts + rng.normal(scale=0.01, size=(n, 3))).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 5, 2001])
def test_farthest_point_sample_same_indices(seed):
    pts = _cloud(seed, 1500)
    idx_t = tcoreset.farthest_point_sample(T(pts), 200, seed)
    idx_j = jcoreset.farthest_point_sample(pts, 200, seed)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert int(idx_t[0]) == seed % len(pts)


def test_farthest_point_sample_ties_pick_first_index():
    # Duplicated grid: every distance ties with the duplicate's.
    grid = np.mgrid[0:4, 0:4, 0:4].reshape(3, -1).T.astype(np.float32)
    pts = np.ascontiguousarray(np.concatenate([grid, grid]))
    idx_t = tcoreset.farthest_point_sample(T(pts), 40, 3)
    idx_j = jcoreset.farthest_point_sample(pts, 40, 3)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))


def test_build_proxy_coreset_matches():
    pts = _cloud(1, 2000)
    cs_t = tcoreset.build(T(pts), size=256, seed=0)
    cs_j = jcoreset.build(pts, size=256, seed=0)
    np.testing.assert_array_equal(cs_t.points.numpy(), np.asarray(cs_j.points))
    np.testing.assert_allclose(float(cs_t.eps), float(cs_j.eps), rtol=1e-6)
    small = tcoreset.build(T(pts[:100]), size=256)
    assert float(small.eps) == 0.0 and small.points.shape == (100, 3)


def test_build_weighted_clusters_match():
    pts = _cloud(2, 1800)
    cl_t = tcoreset.build_weighted(T(pts), size=300, seed=2)
    cl_j = jcoreset.build_weighted(pts, size=300, seed=2)
    np.testing.assert_array_equal(cl_t.reps.numpy(), np.asarray(cl_j.reps))
    np.testing.assert_array_equal(cl_t.weights.numpy(),
                                  np.asarray(cl_j.weights))
    np.testing.assert_allclose(cl_t.deltas.numpy(), np.asarray(cl_j.deltas),
                               rtol=1e-6, atol=1e-7)
    assert float(cl_t.weights.sum()) == len(pts)


def test_state_from_numpy_round_trip():
    pts = _cloud(3, 900)
    cs_j = jcoreset.build(pts, size=128, seed=0)
    cl_j = jcoreset.build_weighted(pts, size=100, seed=2)
    cs, cl = tcoreset.state_from_numpy(
        {"points": cs_j.points, "eps": cs_j.eps, "reps": cl_j.reps,
         "weights": cl_j.weights, "deltas": cl_j.deltas}, "cpu")
    assert cs.points.dtype == torch.float32 and cs.eps.shape == ()
    np.testing.assert_array_equal(cs.points.numpy(), np.asarray(cs_j.points))
    np.testing.assert_array_equal(cl.deltas.numpy(), np.asarray(cl_j.deltas))
    cs_only, none = tcoreset.state_from_numpy(
        {"points": np.asarray(cs_j.points, np.float64), "eps": 0.5}, "cpu")
    assert none is None and cs_only.points.dtype == torch.float32
