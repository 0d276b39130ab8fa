"""Port parity: batched ICP (fgoicp_tpu_torch/models/icp.py) against the
JAX package's icp_batched on the `tests/test_goicp.py::_make_problem`
pairs, at the engine's lane width (16 lanes: identity + the 14 multi-start
rotations, one lane inactive).

Tolerance: sse rtol 1e-4 (+1e-7 absolute, for lanes that converge to zero
residual) and R, t atol 1e-4.  Both sides take the same exact-NN
correspondences; the JAX CPU path ranks by norm expansion and rescores the
winner, so near-ties may resolve differently and the f32 Procrustes sums
run in another order.
"""
import numpy as np
import pytest
import torch

from fgoicp_tpu.models import icp as jicp
from fgoicp_tpu.ops import geometry as jgeo
from fgoicp_tpu_torch.models import icp as ticp
from test_goicp import _make_problem


def _lanes():
    R0 = jgeo.multi_start_rotations()                     # [15, 3, 3]
    R0 = np.concatenate([R0, np.eye(3, dtype=np.float32)[None]])
    t0 = np.zeros((16, 3), np.float32)
    active = np.arange(16) < 15
    return R0, t0, active


@pytest.mark.parametrize("seed,angle,conv", [(0, 2.2, 0.05), (3, 1.0, 0.005)])
def test_icp_batched_matches_jax(seed, angle, conv):
    pct, pcs, _, _ = _make_problem(seed=seed, angle=angle)
    R0, t0, active = _lanes()
    sse_j, R_j, t_j = jicp.icp_batched(pct, pcs, R0, t0, active=active,
                                       max_iter=100,
                                       convergence_threshold=conv)
    sse_t, R_t, t_t = ticp.icp_batched(
        torch.from_numpy(pct), torch.from_numpy(pcs), torch.from_numpy(R0),
        torch.from_numpy(t0), active=torch.from_numpy(active), max_iter=100,
        convergence_threshold=conv)
    np.testing.assert_allclose(sse_t.numpy(), np.asarray(sse_j),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-4)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-4)
    # The inactive lane is untouched: its initial pose, sse never set.
    np.testing.assert_array_equal(R_t[15].numpy(), R0[15])
    assert float(sse_t[15]) >= 1e10


def test_exact_sse_batched_matches_jax():
    pct, pcs, R_true, t_true = _make_problem(seed=2, angle=0.7)
    R, t, _ = _lanes()
    R, t = R[:4], np.tile(t_true, (4, 1))
    R[0] = R_true
    s_j = jicp.exact_sse_batched(pct, pcs, R, t)
    s_t = ticp.exact_sse_batched(torch.from_numpy(pct), torch.from_numpy(pcs),
                                 torch.from_numpy(R), torch.from_numpy(t))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5,
                               atol=1e-9)
    assert float(s_t[0]) < 1e-8  # the true pose fits exactly


def test_icp_register_recovers_small_motion():
    pct, pcs, R_true, t_true = _make_problem(seed=1, angle=0.2)
    sse, R, t = ticp.icp_register(torch.from_numpy(pct), torch.from_numpy(pcs),
                                  convergence_threshold=1e-6)
    assert float(sse) < 1e-8
    np.testing.assert_allclose(R.numpy(), R_true, atol=1e-4)
    np.testing.assert_allclose(t.numpy(), t_true, atol=1e-4)


def _with_outliers(seed=4, n=200, n_out=40):
    """tests/test_goicp.py::test_trimmed_registration_with_outliers' pair:
    20 % of the source points are garbage."""
    pct, pcs, R_true, t_true = _make_problem(seed=seed, angle=1.8, n=n)
    rng = np.random.default_rng(5)
    outliers = rng.uniform(-3, 3, size=(n_out, 3)).astype(np.float32)
    return pct, np.concatenate([pcs, outliers]), R_true, t_true


@pytest.mark.parametrize("conv", [0.05, 0.001])
def test_trimmed_icp_batched_matches_jax(conv):
    pct, pcs, R_true, t_true = _with_outliers()
    keep = int(round(len(pcs) * 0.75))
    R0, t0, active = _lanes()
    sse_j, R_j, t_j = jicp.icp_batched(pct, pcs, R0, t0, active=active,
                                       max_iter=100,
                                       convergence_threshold=conv,
                                       trim_keep=keep)
    sse_t, R_t, t_t = ticp.icp_batched(
        torch.from_numpy(pct), torch.from_numpy(pcs), torch.from_numpy(R0),
        torch.from_numpy(t0), active=torch.from_numpy(active), max_iter=100,
        convergence_threshold=conv, trim_keep=keep)
    np.testing.assert_allclose(sse_t.numpy(), np.asarray(sse_j),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-4)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-4)
    # Some lane trims the outliers away and lands on the true pose.
    best = int(torch.argmin(sse_t))
    np.testing.assert_allclose(R_t[best].numpy(), R_true, atol=1e-3)


def test_trimmed_exact_sse_batched_and_masks_match_jax():
    pct, pcs, R_true, t_true = _with_outliers()
    R, _, _ = _lanes()
    R, t = R[:4], np.tile(t_true, (4, 1))
    R[0] = R_true
    for keep in (len(pcs), 200, 150):
        s_j = jicp.exact_sse_batched(pct, pcs, R, t, trim_keep=keep)
        s_t = ticp.exact_sse_batched(
            torch.from_numpy(pct), torch.from_numpy(pcs), torch.from_numpy(R),
            torch.from_numpy(t), trim_keep=keep)
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5,
                                   atol=1e-9)
    assert float(s_t[0]) < 1e-8  # the inliers fit the true pose exactly
    # Ties at the threshold keep every tied point, as the JAX mask does.
    d2 = torch.tensor([[0.3, 0.1, 0.2, 0.2, 0.5]])
    np.testing.assert_array_equal(ticp.trim_mask(d2, 3).numpy(),
                                  [[0, 1, 1, 1, 0]])
    assert ticp.trim_mask(d2, 5) is None
    np.testing.assert_allclose(float(ticp.trimmed_sum(d2, 2)[0]), 0.3)
    with pytest.raises(ValueError, match="point_weights"):
        ticp.exact_sse_batched(torch.from_numpy(pct), torch.from_numpy(pcs),
                               torch.from_numpy(R), torch.from_numpy(t),
                               trim_keep=10,
                               point_weights=torch.ones(len(pcs)))


@pytest.mark.parametrize("kw,item", [
    (dict(point_weights=torch.ones(160)), "item 13"),
    (dict(target_axis="points"), "item 16"),
])
def test_icp_unported_options_name_their_roadmap_item(kw, item):
    pct, pcs, _, _ = _make_problem()
    R0, t0, _ = _lanes()
    with pytest.raises(NotImplementedError, match=item):
        ticp.icp_batched(torch.from_numpy(pct), torch.from_numpy(pcs),
                         torch.from_numpy(R0), torch.from_numpy(t0), **kw)
