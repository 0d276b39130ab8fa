"""Port parity: the trimmed reductions and `evaluate_bounds`
(fgoicp_tpu_torch/ops/bounds.py, `cuda_bounds.dropsum_bracket`) against the
JAX package's fgoicp_tpu/ops/bounds.py on the same seeded numpy inputs.

Tolerances: the bisection runs in float32 in the same order on both sides,
so its thresholds agree and only the sums' order differs — rtol 1e-5 on
the reductions; evaluate_bounds at rtol 2e-4 / atol 2e-5
(tests/test_pallas_bounds.py), since its distances go through another NN
path on each side.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgoicp_tpu.ops import bounds as jbounds
from fgoicp_tpu.ops import geometry as jgeo
from fgoicp_tpu_torch.ops import bounds as tbounds
from fgoicp_tpu_torch.ops import coreset as tcoreset
from fgoicp_tpu_torch.ops import cuda_bounds

BIG = 1e10


def T(a):
    return torch.from_numpy(np.array(a))


def _terms(seed=0, shape=(6, 300), mask_from=250):
    """Squared-term-like values with ties (a rounded copy) and a 0/1 mask
    over the last points."""
    rng = np.random.default_rng(seed)
    x = rng.gamma(0.6, 0.2, size=shape).astype(np.float32)
    x[:, ::7] = np.round(x[:, ::7], 2)  # exact ties
    x[:, ::11] = 0.0
    w = np.ones(shape[-1], np.float32)
    w[mask_from:] = 0.0
    return x, w


@pytest.mark.parametrize("mode", ["over", "under"])
def test_dropsum_bracket_matches_jax(mode):
    x, w = _terms()
    masked = np.where(w > 0, x * w, -BIG).astype(np.float32)
    for k in (1, 37, 180):
        want = np.asarray(jbounds._dropsum_bracket(jnp.asarray(masked), k,
                                                   mode))
        got = cuda_bounds.dropsum_bracket(T(masked), k, mode).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        exact = np.sort(masked, axis=-1)[:, ::-1][:, :k].clip(min=0).sum(-1)
        if mode == "over":
            assert np.all(got >= exact * (1 - 1e-5) - 1e-6)
        else:
            assert np.all(got <= exact * (1 + 1e-5) + 1e-6)


@pytest.mark.parametrize("drop_mode,weighted,trim", [
    ("exact", True, True), ("over", True, True), ("under", False, True),
    ("exact", False, False)])
def test_reduce_point_terms_matches_jax(drop_mode, weighted, trim):
    x, w = _terms(seed=1)
    pw = w if weighted else None
    trim_ns = 250 if weighted else None
    trim_keep = 170 if trim else None
    want = jbounds.reduce_point_terms(
        jnp.asarray(x), None if pw is None else jnp.asarray(pw), trim_keep,
        None, trim_ns, drop_mode=drop_mode)
    got = tbounds.reduce_point_terms(
        T(x), None if pw is None else T(pw), trim_keep, trim_ns=trim_ns,
        drop_mode=drop_mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_weighted_drop_sum_and_clustered_trim_match_jax():
    rng = np.random.default_rng(6)
    k = 40
    v = rng.uniform(0, 3, size=(5, k)).astype(np.float32)
    v[:, ::5] = v[:, 1:2]  # ties between clusters
    wts = rng.integers(1, 5, size=(k,)).astype(np.float32)
    for n_drop in (1, 17, int(wts.sum()) - 3):
        want = jbounds._weighted_drop_sum(jnp.asarray(v), jnp.asarray(wts),
                                          n_drop)
        got = tbounds._weighted_drop_sum(T(v), T(wts), n_drop)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
        members = np.repeat(v[0], wts.astype(int))
        np.testing.assert_allclose(
            float(got[0]), np.sort(members)[::-1][:n_drop].sum(), rtol=1e-5)
    lb_pt = v * 0.5
    for trim_keep, trim_ns in ((60, int(wts.sum())), (int(wts.sum()), 80)):
        lb_j, ub_j = jbounds.reduce_clustered_trimmed(
            jnp.asarray(lb_pt), jnp.asarray(v), jnp.asarray(wts), trim_keep,
            trim_ns)
        lb_t, ub_t = tbounds.reduce_clustered_trimmed(
            T(lb_pt), T(v), T(wts), trim_keep, trim_ns)
        np.testing.assert_allclose(lb_t.numpy(), np.asarray(lb_j),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ub_t.numpy(), np.asarray(ub_j),
                                   rtol=1e-5, atol=1e-6)


def _grid_problem(seed=2, g=4, b=6, ns=300, p=120):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        pcs=f32(rng.uniform(-0.7, 0.7, size=(ns, 3))),
        proxies=f32(rng.uniform(-0.9, 0.9, size=(p, 3))),
        xyz=f32(rng.uniform(-0.4, 0.4, size=(g, 3))),
        spans=f32(rng.uniform(0.05, 0.3, size=(g,))),
        fix=np.arange(g) % 2 == 0,
        tc=f32(rng.uniform(-0.4, 0.4, size=(g, b, 3))),
        ts=f32(rng.uniform(0.05, 0.3, size=(g, b))),
        weights=f32(rng.integers(1, 5, size=(ns,))),
        deltas=f32(rng.uniform(0.0, 0.03, size=(ns,))),
        mask=rng.uniform(size=(g, b)) < 0.7)


@pytest.mark.parametrize("case", ["untrimmed", "trimmed", "clustered_trimmed",
                                  "node_mask"])
def test_evaluate_bounds_matches_jax(case):
    c = _grid_problem()
    ns = c["pcs"].shape[0]
    kw_j, kw_t = {}, {}
    if case in ("trimmed", "clustered_trimmed"):
        kw_j["trim_keep"] = kw_t["trim_keep"] = int(0.75 * ns)
    if case == "clustered_trimmed":
        total = int(c["weights"].sum())
        kw_j.update(point_weights=jnp.asarray(c["weights"]),
                    point_deltas=jnp.asarray(c["deltas"]), trim_ns=total,
                    trim_keep=int(0.75 * total))
        kw_t.update(point_weights=T(c["weights"]),
                    point_deltas=T(c["deltas"]), trim_ns=total,
                    trim_keep=int(0.75 * total))
    if case == "node_mask":
        kw_j["node_mask"] = jnp.asarray(c["mask"])
        kw_t["node_mask"] = T(c["mask"])
    slack = np.float32(0.02)
    jb = jbounds.ProxyBackend(coreset=jbounds.coreset_ops.ProxyCoreset(
        points=jnp.asarray(c["proxies"]), eps=jnp.float32(slack)))
    R = jgeo.quat_cube_to_matrix(jnp.asarray(c["xyz"]))
    lb_j, ub_j = jbounds.evaluate_bounds(
        jb, jnp.asarray(c["pcs"]), R, jnp.asarray(c["spans"]),
        jnp.asarray(c["fix"]), jnp.asarray(c["tc"]), jnp.asarray(c["ts"]),
        **kw_j)
    cs, _ = tcoreset.state_from_numpy(
        {"points": c["proxies"], "eps": slack}, "cpu")
    before = cuda_bounds.fused_bounds.launches
    lb_t, ub_t = tbounds.evaluate_bounds(
        tbounds.ProxyBackend(coreset=cs), T(c["pcs"]), T(R), T(c["spans"]),
        T(c["fix"]), T(c["tc"]), T(c["ts"]), **kw_t)
    assert cuda_bounds.fused_bounds.launches == before  # CPU: plain version
    np.testing.assert_allclose(ub_t.numpy(), np.asarray(ub_j), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(lb_t.numpy(), np.asarray(lb_j), rtol=2e-4,
                               atol=2e-5)
    live = c["mask"] if case == "node_mask" else np.ones_like(c["mask"])
    assert np.all(lb_t.numpy()[live] <= ub_t.numpy()[live] + 1e-5)
    if case == "node_mask":
        assert np.all(lb_t.numpy()[~live] == BIG)


def test_trimmed_bounds_bracket_trimmed_sse():
    """lb <= trimmed SSE(R, t) for poses inside the node and trimmed
    SSE(center) <= ub, through evaluate_bounds' trimmed branch."""
    from fgoicp_tpu_torch.models import icp as ticp
    from fgoicp_tpu_torch.ops import geometry as tgeo
    rng = np.random.default_rng(12)
    tgt = T(rng.uniform(-1, 1, size=(500, 3)).astype(np.float32))
    src = T(rng.uniform(-0.8, 0.8, size=(200, 3)).astype(np.float32))
    backend = tbounds.make_backend(tgt, kind="proxy", proxy_size=96, seed=0)
    g, keep = 5, 150
    xyz = T(rng.uniform(-0.4, 0.4, size=(g, 3)).astype(np.float32))
    spans = T(rng.uniform(0.02, 0.08, size=(g,)).astype(np.float32))
    tc = T(rng.uniform(-0.3, 0.3, size=(g, 1, 3)).astype(np.float32))
    ts = T(rng.uniform(0.02, 0.08, size=(g, 1)).astype(np.float32))
    R = tgeo.quat_cube_to_matrix(xyz)
    lb, _ = tbounds.evaluate_bounds(backend, src, R, spans,
                                    torch.zeros(g, dtype=bool), tc, ts,
                                    trim_keep=keep)
    _, ub = tbounds.evaluate_bounds(backend, src, R, spans,
                                    torch.ones(g, dtype=bool), tc, ts,
                                    trim_keep=keep)
    sse_c = ticp.exact_sse_batched(tgt, src, R, tc[:, 0], trim_keep=keep)
    assert bool(torch.all(sse_c <= ub[:, 0] * (1 + 1e-5) + 1e-5))
    for _ in range(6):
        dx = T(rng.uniform(-1, 1, size=(g, 3)).astype(np.float32))
        dt = T(rng.uniform(-1, 1, size=(g, 3)).astype(np.float32))
        Rr = tgeo.quat_cube_to_matrix(xyz + dx * spans[:, None])
        sse = ticp.exact_sse_batched(tgt, src, Rr, tc[:, 0] + dt * ts,
                                     trim_keep=keep)
        assert bool(torch.all(lb[:, 0] <= sse * (1 + 1e-5) + 1e-5))


def test_point_sharding_names_its_roadmap_item():
    x, w = _terms()
    with pytest.raises(NotImplementedError, match="item 16"):
        tbounds.reduce_point_terms(T(x), T(w), 10, points_axis="points")
    with pytest.raises(ValueError, match="clustered trimming"):
        c = _grid_problem(g=1, b=1, ns=10, p=5)
        cs, _ = tcoreset.state_from_numpy(
            {"points": c["proxies"], "eps": np.float32(0.0)}, "cpu")
        tbounds.evaluate_bounds(
            tbounds.ProxyBackend(coreset=cs), T(c["pcs"]), torch.eye(3)[None],
            T(c["spans"]), T(c["fix"]), T(c["tc"]), T(c["ts"]), trim_keep=5,
            point_deltas=T(c["deltas"]))
