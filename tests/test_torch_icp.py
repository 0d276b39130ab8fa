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


# The ids are those the cases had beside the point_weights case, which went
# with the serving port (point weights are now parity-tested below).
@pytest.mark.parametrize("kw,item", [
    (dict(target_axis="points"), "item 16"),
], ids=["kw1-item 16"])
def test_icp_unported_options_name_their_roadmap_item(kw, item):
    pct, pcs, _, _ = _make_problem()
    R0, t0, _ = _lanes()
    with pytest.raises(NotImplementedError, match=item):
        ticp.icp_batched(torch.from_numpy(pct), torch.from_numpy(pcs),
                         torch.from_numpy(R0), torch.from_numpy(t0), **kw)


def _serving_lanes():
    """Per-lane sources: G = 8 lanes, each a different 80-point subsample of
    the problem's source moved by its own small rotation, from the 8
    octant-centre starts; ragged 0/1 weights (the serving batch's padding)
    and soft weights."""
    pct, pcs, _, _ = _make_problem(seed=6, angle=0.6)
    rng = np.random.default_rng(23)
    g, ns = 8, 80
    srcs = []
    for lane in range(g):
        idx = rng.choice(len(pcs), size=ns, replace=False)
        ang = rng.uniform(-0.2, 0.2)
        c, s_ = np.cos(ang), np.sin(ang)
        Rl = np.array([[1, 0, 0], [0, c, -s_], [0, s_, c]], np.float32)
        srcs.append(pcs[idx] @ Rl.T)
    srcs = np.stack(srcs).astype(np.float32)
    R0 = jgeo.multi_start_rotations()[1:1 + g]
    t0 = rng.uniform(-0.05, 0.05, size=(g, 3)).astype(np.float32)
    ragged = np.ones((g, ns), np.float32)
    for lane, n in enumerate((80, 60, 41, 80, 75, 20, 66, 53)):
        ragged[lane, n:] = 0.0
        srcs[lane, n:] = srcs[lane, 0]
    soft = rng.uniform(0.2, 1.5, size=(g, ns)).astype(np.float32)
    shared = rng.uniform(0.5, 1.0, size=(ns,)).astype(np.float32)
    return pct, srcs, R0, t0, dict(none=None, ragged=ragged, soft=soft,
                                   shared=shared)


@pytest.mark.parametrize("weights", ["none", "ragged", "soft", "shared"])
def test_per_lane_icp_batched_matches_jax(weights):
    """[G, ns, 3] sources with no weights, [G, ns] 0/1 ragged weights, soft
    weights and [ns] weights (the serving mode's lanes)."""
    pct, srcs, R0, t0, ws = _serving_lanes()
    w = ws[weights]
    sse_j, R_j, t_j = jicp.icp_batched(pct, srcs, R0, t0, max_iter=100,
                                       convergence_threshold=0.005,
                                       point_weights=w)
    sse_t, R_t, t_t = ticp.icp_batched(
        torch.from_numpy(pct), torch.from_numpy(srcs), torch.from_numpy(R0),
        torch.from_numpy(t0), max_iter=100, convergence_threshold=0.005,
        point_weights=None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(sse_t.numpy(), np.asarray(sse_j),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-4)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-4)

    # exact_sse_batched at the ICP's poses, per-lane sources and weights.
    s_j = jicp.exact_sse_batched(pct, srcs, np.asarray(R_j), np.asarray(t_j),
                                 point_weights=w)
    s_t = ticp.exact_sse_batched(
        torch.from_numpy(pct), torch.from_numpy(srcs), R_t, t_t,
        point_weights=None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-4,
                               atol=1e-7)
    # The ICP's carried SSE is its last exact pass: the two agree.
    np.testing.assert_allclose(s_t.numpy(), sse_t.numpy(), rtol=1e-5,
                               atol=1e-9)


def test_point_weights_mask_padding_exactly():
    """Zero-weight padding rows change nothing: a ragged lane's ICP equals
    that cloud run alone, and trimmed_sum / trim_mask take the weights
    (trim_mask returns them untrimmed)."""
    pct, srcs, R0, t0, ws = _serving_lanes()
    lane, n = 2, 41
    w = torch.from_numpy(ws["ragged"])
    sse, R, t = ticp.icp_batched(
        torch.from_numpy(pct), torch.from_numpy(srcs), torch.from_numpy(R0),
        torch.from_numpy(t0), point_weights=w)
    sse1, R1, t1 = ticp.icp_batched(
        torch.from_numpy(pct), torch.from_numpy(srcs[lane, :n]),
        torch.from_numpy(R0[lane:lane + 1]), torch.from_numpy(t0[lane:lane + 1]))
    np.testing.assert_allclose(float(sse[lane]), float(sse1[0]), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(R[lane].numpy(), R1[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(t[lane].numpy(), t1[0].numpy(), atol=1e-5)
    d2 = torch.tensor([[0.3, 0.1, 0.2, 0.2, 0.5]])
    wt = torch.tensor([[1.0, 0.5, 0.0, 2.0, 1.0]])
    assert ticp.trim_mask(d2, None, wt) is wt
    assert ticp.trim_mask(d2, 5, wt) is wt
    np.testing.assert_allclose(float(ticp.trimmed_sum(d2, None, wt)[0]), 1.25)
    with pytest.raises(ValueError, match="point_weights"):
        ticp.icp_batched(torch.from_numpy(pct), torch.from_numpy(srcs),
                         torch.from_numpy(R0), torch.from_numpy(t0),
                         trim_keep=40, point_weights=w)
