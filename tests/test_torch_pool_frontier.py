"""Port parity: the pooled inner BnB (fgoicp_tpu_torch/ops/pool_frontier.py)
against the JAX package's bnb_r3_pooled (sort update, XLA lane path on the
CPU), both running on exactly the JAX package's proxy coreset and source
clusters (handed over with `coreset.state_from_numpy`), with ub-pass /
lb-pass twin groups sharing incumbents as the engine runs them.

Compared per group: best_ub, lb_raw = min(best_ub, best_err) and
dropped_lb (rtol 1e-4: the lane sums round in another order), and the
search counters, which must be equal.  A forced-overflow case checks the dropped_lb clamp.
Trimmed searches run plain source points (the trimmed lane kernel's plain
version against the JAX XLA lane path) and clusters (member-level trim).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgoicp_tpu.ops import bounds as jbounds
from fgoicp_tpu.ops import coreset as jcoreset
from fgoicp_tpu.ops import geometry as jgeo
from fgoicp_tpu.ops import pool_frontier as jpool
from fgoicp_tpu_torch.ops import bounds as tbounds
from fgoicp_tpu_torch.ops import coreset as tcoreset
from fgoicp_tpu_torch.ops import cuda_bounds
from fgoicp_tpu_torch.ops import pool_frontier as tpool

INVALID = 1e30


def _problem(seed=0, nt=400, ns=260, children=3):
    """A proxy backend (eps > 0) and weighted source clusters built by the
    JAX package, and 2 x `children` groups: lanes [0:c) the fixed-rotation
    ub pass, [c:2c) the lb pass pointing at their twins."""
    rng = np.random.default_rng(seed)
    pct = rng.uniform(-0.8, 0.8, size=(nt, 3)).astype(np.float32)
    pcs = rng.uniform(-0.6, 0.6, size=(ns, 3)).astype(np.float32)
    backend = jbounds.make_backend(pct, kind="proxy", proxy_size=96, seed=0)
    clusters = jcoreset.build_weighted(pcs, size=64, seed=2)
    xyz = rng.uniform(-0.5, 0.5, size=(children, 3)).astype(np.float32)
    R = np.asarray(jgeo.quat_cube_to_matrix(xyz))
    R2 = np.concatenate([R, R])
    spans2 = np.full((2 * children,), 0.125, np.float32)
    fix2 = np.arange(2 * children) < children
    share = np.concatenate([np.full(children, -1),
                            np.arange(children)]).astype(np.int32)
    return backend, clusters, R2, spans2, fix2, share


def _run_both(backend, clusters, R2, spans2, fix2, share, best_sse=1e9,
              group_active=None, sse_threshold=1e-4, **kw):
    st_j = jpool.bnb_r3_pooled(
        backend, clusters.reps, jnp.asarray(R2), jnp.asarray(spans2),
        jnp.asarray(fix2), jnp.float32(best_sse), jnp.float32(sse_threshold),
        group_active=(None if group_active is None
                      else jnp.asarray(group_active)),
        point_weights=clusters.weights, point_deltas=clusters.deltas,
        err_share_from=jnp.asarray(share), **kw)
    cs, cl = tcoreset.state_from_numpy(
        {"points": backend.coreset.points, "eps": backend.coreset.eps,
         "reps": clusters.reps, "weights": clusters.weights,
         "deltas": clusters.deltas}, "cpu")
    tb = tbounds.ProxyBackend(coreset=cs)
    st_t = tpool.bnb_r3_pooled(
        tb, cl.reps, torch.from_numpy(R2), torch.from_numpy(spans2),
        torch.from_numpy(fix2), float(np.float32(best_sse)),
        float(np.float32(sse_threshold)),
        group_active=(None if group_active is None
                      else torch.from_numpy(group_active)),
        point_weights=cl.weights, point_deltas=cl.deltas,
        err_share_from=torch.from_numpy(share), **kw)
    return st_j, st_t


def _per_group(st, numpy):
    a = (lambda x: np.asarray(x)) if numpy else (lambda x: x.numpy())
    best_ub, best_err = a(st.best_ub), a(st.best_err)
    return best_ub, np.minimum(best_ub, best_err), a(st.dropped_lb)


@pytest.mark.parametrize("seed", [0, 1])
def test_pooled_matches_jax(seed):
    args = _problem(seed=seed)
    st_j, st_t = _run_both(*args, min_span=0.2, lanes=32, capacity=4096,
                           max_steps=2000)
    for got, want in zip(_per_group(st_t, False), _per_group(st_j, True)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert int(st_t.dropped) == int(st_j.dropped) == 0
    assert np.all(st_t.dropped_lb.numpy() >= INVALID)
    # The same search: the stable sort keeps the JAX pop order.
    assert st_t.steps == int(st_j.steps)
    np.testing.assert_array_equal(st_t.evaluated.numpy(),
                                  np.asarray(st_j.evaluated))
    assert not st_t.active.any()


def test_pooled_matches_jax_with_incumbent_and_inactive_groups():
    act = np.asarray([True, False, True, True, False, True])
    st_j, st_t = _run_both(*_problem(seed=2), best_sse=5.0,
                           group_active=act, lanes=32, capacity=4096)
    for got, want in zip(_per_group(st_t, False), _per_group(st_j, True)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    ev = st_t.evaluated.numpy()
    assert np.all(ev[~act] == 0) and np.all(ev[act] > 0)
    np.testing.assert_array_equal(ev, np.asarray(st_j.evaluated))


def test_pool_overflow_matches_jax_and_keeps_lb_sound():
    """Capacity g + 4 forces drops: dropped counts and the dropped_lb clamp
    match the JAX package, and the clamped lb stays below the achieved
    optimum of an unconstrained search."""
    args = _problem(seed=4)
    g = args[2].shape[0]
    st_j, st_t = _run_both(*args, lanes=8, capacity=g + 4, max_steps=3000)
    assert int(st_t.dropped) > 0
    assert int(st_t.dropped) == int(st_j.dropped)
    assert st_t.steps == int(st_j.steps)
    for got, want in zip(_per_group(st_t, False), _per_group(st_j, True)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    _, big = _run_both(*args, lanes=32, capacity=8192, max_steps=3000)
    _, lb_raw, dropped_lb = _per_group(st_t, False)
    assert np.all(np.minimum(lb_raw, dropped_lb)
                  <= big.best_ub.numpy() + 1e-5)


def test_pool_max_steps_exit_folds_frontier_min():
    args = _problem(seed=6)
    st_j, st_t = _run_both(*args, lanes=8, capacity=4096, max_steps=2)
    assert st_t.steps == int(st_j.steps) == 2
    act = st_t.active.numpy()
    assert act.any()
    np.testing.assert_array_equal(act, np.asarray(st_j.active))
    assert np.all(st_t.dropped_lb.numpy()[act] < INVALID)
    np.testing.assert_allclose(st_t.dropped_lb.numpy(),
                               np.asarray(st_j.dropped_lb), rtol=1e-4)


def _run_trimmed(seed, clustered, ns=260, keep_share=0.75, **kw):
    """Trimmed pooled searches in both packages: plain source points (the
    trimmed lane kernel's plain version; the JAX XLA lane path) or the
    JAX-built source clusters with the member-level clustered trim."""
    backend, clusters, R2, spans2, fix2, share = _problem(seed=seed, ns=ns)
    rng = np.random.default_rng(seed)
    pcs = rng.uniform(-0.6, 0.6, size=(ns, 3)).astype(np.float32)
    trim_keep = int(round(ns * keep_share))
    if clustered:
        src = np.asarray(clusters.reps)
        extra_j = dict(point_weights=clusters.weights,
                       point_deltas=clusters.deltas, trim_ns=ns)
    else:
        src, extra_j = pcs, {}
    st_j = jpool.bnb_r3_pooled(
        backend, jnp.asarray(src), jnp.asarray(R2), jnp.asarray(spans2),
        jnp.asarray(fix2), jnp.float32(1e9), jnp.float32(1e-4),
        err_share_from=jnp.asarray(share), trim_keep=trim_keep, **extra_j,
        **kw)
    cs, cl = tcoreset.state_from_numpy(
        {"points": backend.coreset.points, "eps": backend.coreset.eps,
         "reps": clusters.reps, "weights": clusters.weights,
         "deltas": clusters.deltas}, "cpu")
    extra_t = (dict(point_weights=cl.weights, point_deltas=cl.deltas,
                    trim_ns=ns) if clustered else {})
    st_t = tpool.bnb_r3_pooled(
        tbounds.ProxyBackend(coreset=cs), torch.from_numpy(src.copy()),
        torch.from_numpy(R2), torch.from_numpy(spans2),
        torch.from_numpy(fix2), float(np.float32(1e9)),
        float(np.float32(1e-4)), err_share_from=torch.from_numpy(share),
        trim_keep=trim_keep, **extra_t, **kw)
    return st_j, st_t


@pytest.mark.parametrize("seed,clustered", [(0, False), (1, False),
                                            (0, True), (3, True)])
def test_trimmed_pooled_matches_jax(seed, clustered):
    before = (cuda_bounds.fused_bounds_lanes.launches,
              cuda_bounds.fused_bounds_lanes_trimmed.launches)
    st_j, st_t = _run_trimmed(seed, clustered, min_span=0.2, lanes=32,
                              capacity=4096, max_steps=2000)
    # On the CPU the lanes run the kernels' plain versions.
    assert (cuda_bounds.fused_bounds_lanes.launches,
            cuda_bounds.fused_bounds_lanes_trimmed.launches) == before
    for got, want in zip(_per_group(st_t, False), _per_group(st_j, True)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert st_t.steps == int(st_j.steps)
    np.testing.assert_array_equal(st_t.evaluated.numpy(),
                                  np.asarray(st_j.evaluated))
    assert int(st_t.dropped) == int(st_j.dropped) == 0
    assert not st_t.active.any()


def test_clustered_trim_needs_weights_and_member_count():
    cs, cl = tcoreset.state_from_numpy(
        {"points": np.zeros((4, 3), np.float32), "eps": np.float32(0.0),
         "reps": np.ones((6, 3), np.float32),
         "weights": np.ones(6, np.float32),
         "deltas": np.zeros(6, np.float32)}, "cpu")
    with pytest.raises(ValueError, match="clustered trimming"):
        tpool.bnb_r3_pooled(
            tbounds.ProxyBackend(coreset=cs), cl.reps, torch.eye(3)[None],
            torch.ones(1), torch.ones(1, dtype=torch.bool), 1e9, 1e-4,
            trim_keep=3, point_weights=cl.weights, point_deltas=cl.deltas)


@pytest.mark.parametrize("kw,match", [
    (dict(pool_update="merge"), "merge"),
    (dict(points_axis="points"), "item 16"),
])
def test_pooled_unported_options_raise(kw, match):
    backend, clusters, R2, spans2, fix2, share = _problem(seed=0, children=1)
    cs, cl = tcoreset.state_from_numpy(
        {"points": backend.coreset.points, "eps": backend.coreset.eps}, "cpu")
    with pytest.raises(NotImplementedError, match=match):
        tpool.bnb_r3_pooled(
            tbounds.ProxyBackend(coreset=cs), torch.from_numpy(
                np.array(clusters.reps)), torch.from_numpy(R2),
            torch.from_numpy(spans2), torch.from_numpy(fix2), 1e9, 1e-4, **kw)
