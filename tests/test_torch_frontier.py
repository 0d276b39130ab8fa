"""Port parity: the grouped inner BnB (fgoicp_tpu_torch/ops/frontier.py,
`frontier_mode="grouped"`) against the JAX package's bnb_r3_batched (XLA
bound path on the CPU), both on exactly the JAX package's proxy coreset
(handed over with `coreset.state_from_numpy`), untrimmed and trimmed, with
ub-pass (fixed rotation) and lb-pass groups as the engine runs them.

Compared per group: best_ub, lb_raw = min(best_ub, best_err) and
dropped_lb (rtol 1e-4: the bound sums round in another order), and the
search counters, which must be equal: the stable sort keeps the JAX pop
order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgoicp_tpu.ops import bounds as jbounds
from fgoicp_tpu.ops import frontier as jfrontier
from fgoicp_tpu.ops import geometry as jgeo
from fgoicp_tpu_torch.ops import bounds as tbounds
from fgoicp_tpu_torch.ops import coreset as tcoreset
from fgoicp_tpu_torch.ops import cuda_bounds
from fgoicp_tpu_torch.ops import frontier as tfrontier

INVALID = 1e30


def _run_both(seed=0, nt=400, ns=220, children=3, trim_keep=None,
              best_sse=1e9, group_active=None, **kw):
    rng = np.random.default_rng(seed)
    pct = rng.uniform(-0.8, 0.8, size=(nt, 3)).astype(np.float32)
    pcs = rng.uniform(-0.6, 0.6, size=(ns, 3)).astype(np.float32)
    backend = jbounds.make_backend(pct, kind="proxy", proxy_size=96, seed=0)
    xyz = rng.uniform(-0.5, 0.5, size=(children, 3)).astype(np.float32)
    R = np.asarray(jgeo.quat_cube_to_matrix(xyz))
    R2 = np.concatenate([R, R])
    spans2 = np.full((2 * children,), 0.125, np.float32)
    fix2 = np.arange(2 * children) < children
    st_j = jfrontier.bnb_r3_batched(
        backend, jnp.asarray(pcs), jnp.asarray(R2), jnp.asarray(spans2),
        jnp.asarray(fix2), jnp.float32(best_sse), jnp.float32(1e-4),
        group_active=(None if group_active is None
                      else jnp.asarray(group_active)),
        trim_keep=trim_keep, **kw)
    cs, _ = tcoreset.state_from_numpy(
        {"points": backend.coreset.points, "eps": backend.coreset.eps}, "cpu")
    st_t = tfrontier.bnb_r3_batched(
        tbounds.ProxyBackend(coreset=cs), torch.from_numpy(pcs),
        torch.from_numpy(R2), torch.from_numpy(spans2),
        torch.from_numpy(fix2), float(np.float32(best_sse)),
        float(np.float32(1e-4)),
        group_active=(None if group_active is None
                      else torch.from_numpy(group_active)),
        trim_keep=trim_keep, **kw)
    return st_j, st_t


def _assert_same_search(st_j, st_t):
    best_ub_t, best_ub_j = st_t.best_ub.numpy(), np.asarray(st_j.best_ub)
    np.testing.assert_allclose(best_ub_t, best_ub_j, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(
        np.minimum(best_ub_t, st_t.best_err.numpy()),
        np.minimum(best_ub_j, np.asarray(st_j.best_err)), rtol=1e-4,
        atol=1e-6)
    np.testing.assert_allclose(st_t.dropped_lb.numpy(),
                               np.asarray(st_j.dropped_lb), rtol=1e-4)
    assert st_t.steps == int(st_j.steps)
    np.testing.assert_array_equal(st_t.evaluated.numpy(),
                                  np.asarray(st_j.evaluated))
    np.testing.assert_array_equal(st_t.dropped.numpy(),
                                  np.asarray(st_j.dropped))
    np.testing.assert_array_equal(st_t.active.numpy(),
                                  np.asarray(st_j.active))


@pytest.mark.parametrize("seed,trim", [(0, False), (1, False), (0, True),
                                       (2, True)])
def test_grouped_matches_jax(seed, trim):
    before = cuda_bounds.fused_bounds.launches
    st_j, st_t = _run_both(seed=seed, trim_keep=165 if trim else None,
                           min_span=0.2, batch=8, capacity=512)
    assert cuda_bounds.fused_bounds.launches == before  # CPU: plain version
    _assert_same_search(st_j, st_t)
    assert not st_t.active.any()
    assert np.all(st_t.dropped_lb.numpy() >= INVALID)
    assert np.all(st_t.evaluated.numpy() > 0)


def test_grouped_matches_jax_with_incumbent_and_inactive_groups():
    act = np.asarray([True, False, True, True, False, True])
    st_j, st_t = _run_both(seed=3, best_sse=5.0, group_active=act,
                           min_span=0.2, batch=8, capacity=512)
    _assert_same_search(st_j, st_t)
    ev = st_t.evaluated.numpy()
    assert np.all(ev[~act] == 0) and np.all(ev[act] > 0)


def test_grouped_overflow_and_max_steps_keep_lb_sound():
    """A small capacity drops nodes (counted, dropped_lb clamps the lb) and
    a max_steps exit folds the open frontier minimum, as in JAX."""
    st_j, st_t = _run_both(seed=4, min_span=0.2, batch=8, capacity=40)
    _assert_same_search(st_j, st_t)
    assert int(st_t.dropped.sum()) > 0
    st_j, st_t = _run_both(seed=5, batch=4, capacity=512, max_steps=2)
    _assert_same_search(st_j, st_t)
    act = st_t.active.numpy()
    assert st_t.steps == 2 and act.any()
    assert np.all(st_t.dropped_lb.numpy()[act] < INVALID)


def test_grouped_sharding_names_its_roadmap_item():
    cs, _ = tcoreset.state_from_numpy(
        {"points": np.zeros((4, 3), np.float32), "eps": np.float32(0.0)},
        "cpu")
    with pytest.raises(NotImplementedError, match="item 16"):
        tfrontier.bnb_r3_batched(
            tbounds.ProxyBackend(coreset=cs), torch.ones(5, 3),
            torch.eye(3)[None], torch.ones(1),
            torch.ones(1, dtype=torch.bool), 1e9, 1e-4, points_axis="points")
