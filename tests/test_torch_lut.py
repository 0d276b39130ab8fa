"""Port parity: the LUT bound backend (fgoicp_tpu_torch/ops/bounds.py's LUT
half, and its lanes in ops/pool_frontier.py and ops/frontier.py) against the
JAX package, both on the same distance field: the JAX package builds it and
the port takes its arrays with `distance_field.field_from_numpy`.

Tolerances: distance estimates rtol 1e-6 / atol 1e-6 (the same lookups and
bracket formulas in float32); node bounds rtol 2e-4 / atol 2e-5, the bound
tolerance of tests/test_pallas_bounds.py (the sums over source points run
in another order).  Searches must take the same steps and evaluate the same
nodes per group, as tests/test_torch_pool_frontier.py holds the proxy path.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgoicp_tpu.ops import bounds as jbounds
from fgoicp_tpu.ops import coreset as jcoreset
from fgoicp_tpu.ops import distance_field as jdf
from fgoicp_tpu.ops import frontier as jfrontier
from fgoicp_tpu.ops import geometry as jgeo
from fgoicp_tpu.ops import pool_frontier as jpool
from fgoicp_tpu_torch.ops import bounds as tbounds
from fgoicp_tpu_torch.ops import cuda_bounds
from fgoicp_tpu_torch.ops import distance_field as tdf
from fgoicp_tpu_torch.ops import frontier as tfrontier
from fgoicp_tpu_torch.ops import pool_frontier as tpool


def T(a):
    return torch.from_numpy(np.array(a))


def _target(seed=0, nt=400):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.8, 0.8, size=(nt, 3)).astype(np.float32)


def _fields(pct, res=0.08, builder="edt", dtype=jnp.float32):
    b = np.stack([pct.min(0), pct.max(0)], axis=-1)
    fj = jdf.build(pct, b, res, builder=builder, dtype=dtype)
    ft = tdf.field_from_numpy(np.asarray(fj.values), np.asarray(fj.origin),
                              np.asarray(fj.inv_res),
                              np.asarray(fj.assign_delta),
                              np.asarray(fj.quant_eps), "cpu")
    return fj, ft


def _backends(pct, builder="edt", dtype=jnp.float32, **kw):
    fj, ft = _fields(pct, builder=builder, dtype=dtype)
    bj = jbounds.make_backend(pct, kind="lut", field=fj, **kw)
    bt = tbounds.make_backend(T(pct), kind="lut", field=ft, **kw)
    return bj, bt


@pytest.mark.parametrize("kw", [
    dict(), dict(conservative=False), dict(ref_compat=True),
    dict(lookup="trilinear"), dict(conservative=False, lookup="nearest"),
    dict(ref_compat=True, conservative=True, lookup="nearest"),
])
def test_make_backend_lut_flags_match_jax(kw):
    pct = _target()
    bj, bt = _backends(pct, **kw)
    assert (bt.conservative, bt.ref_compat, bt.lookup) == \
        (bj.conservative, bj.ref_compat, bj.lookup)
    np.testing.assert_array_equal(np.float32(bt.interp_slack),
                                  np.float32(bj.interp_slack))


def test_make_backend_lut_refusals():
    with pytest.raises(ValueError, match="DistanceField"):
        tbounds.make_backend(T(_target()), kind="lut")
    _, ft = _fields(_target())
    with pytest.raises(ValueError, match="lookup mode"):
        tbounds.make_backend(None, kind="lut", field=ft, lookup="cubic")


@pytest.mark.parametrize("builder,dtype,kw", [
    ("edt", jnp.float32, dict()),                         # conservative nearest
    ("edt", jnp.float32, dict(lookup="trilinear")),       # conservative trilinear
    ("edt", jnp.bfloat16, dict()),                        # quant_eps folded in
    ("brute", jnp.float32, dict(conservative=False)),     # raw trilinear
    ("ref", jnp.float32, dict(ref_compat=True)),          # reference compat
])
def test_distance_estimates_match_jax(builder, dtype, kw):
    pct = _target(seed=1)
    bj, bt = _backends(pct, builder=builder, dtype=dtype, **kw)
    rng = np.random.default_rng(2)
    q = rng.uniform(-1.6, 1.6, size=(5, 60, 3)).astype(np.float32)
    ub_j, lb_j = jbounds.distance_estimates(bj, jnp.asarray(q))
    ub_t, lb_t = tbounds.distance_estimates(bt, T(q))
    np.testing.assert_allclose(ub_t.numpy(), np.asarray(ub_j), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(lb_t.numpy(), np.asarray(lb_j), rtol=1e-6,
                               atol=1e-6)
    if bt.conservative:
        assert bool(torch.all(lb_t <= ub_t))


def _grid_case(seed=4, g=4, b=6, ns=90):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        pcs=f32(rng.uniform(-0.6, 0.6, size=(ns, 3))),
        R=np.asarray(jgeo.quat_cube_to_matrix(
            f32(rng.uniform(-0.4, 0.4, size=(g, 3))))),
        spans=f32(rng.uniform(0.05, 0.3, size=(g,))),
        fix=np.asarray([True, False, True, False][:g]),
        tc=f32(rng.uniform(-0.4, 0.4, size=(g, b, 3))),
        ts=f32(rng.uniform(0.05, 0.3, size=(g, b))),
        mask=rng.uniform(size=(g, b)) < 0.8,
        weights=f32(rng.integers(1, 5, size=(ns,))),
        deltas=f32(rng.uniform(0.0, 0.03, size=(ns,))))


@pytest.mark.parametrize("mode", ["untrimmed", "weighted", "trimmed",
                                  "clustered_trimmed"])
def test_evaluate_bounds_lut_matches_jax(mode):
    pct = _target(seed=3)
    bj, bt = _backends(pct)
    c = _grid_case()
    ns = c["pcs"].shape[0]
    kw = dict()
    if mode == "weighted":
        kw = dict(point_weights=c["weights"], point_deltas=c["deltas"])
    elif mode == "trimmed":
        kw = dict(trim_keep=int(0.7 * ns))
    elif mode == "clustered_trimmed":
        kw = dict(point_weights=c["weights"], point_deltas=c["deltas"],
                  trim_keep=int(0.7 * c["weights"].sum()),
                  trim_ns=int(c["weights"].sum()))
    args = ("pcs", "R", "spans", "fix", "tc", "ts")
    lb_j, ub_j = jbounds.evaluate_bounds(
        bj, *[jnp.asarray(c[k]) for k in args],
        node_mask=jnp.asarray(c["mask"]),
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    before = cuda_bounds.fused_bounds.launches
    lb_t, ub_t = tbounds.evaluate_bounds(
        bt, *[T(c[k]) for k in args], node_mask=T(c["mask"]),
        **{k: (T(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    assert cuda_bounds.fused_bounds.launches == before
    np.testing.assert_allclose(lb_t.numpy(), np.asarray(lb_j), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(ub_t.numpy(), np.asarray(ub_j), rtol=2e-4,
                               atol=2e-5)
    live = c["mask"]
    assert bool(torch.all(lb_t[T(live)] <= ub_t[T(live)] + 1e-5))
    assert np.all(lb_t.numpy()[~live] >= 1e10)


def _search_problem(seed, children=3, ns=200):
    rng = np.random.default_rng(seed)
    pct = _target(seed=seed + 10)
    pcs = rng.uniform(-0.6, 0.6, size=(ns, 3)).astype(np.float32)
    xyz = rng.uniform(-0.5, 0.5, size=(children, 3)).astype(np.float32)
    R = np.asarray(jgeo.quat_cube_to_matrix(xyz))
    return dict(pct=pct, pcs=pcs, R2=np.concatenate([R, R]),
                spans2=np.full((2 * children,), 0.125, np.float32),
                fix2=np.arange(2 * children) < children,
                share=np.concatenate([np.full(children, -1),
                                      np.arange(children)]).astype(np.int32))


def _assert_same_search(st_j, st_t):
    for got, want in ((st_t.best_ub, st_j.best_ub),
                      (torch.minimum(st_t.best_ub, st_t.best_err),
                       jnp.minimum(st_j.best_ub, st_j.best_err)),
                      (st_t.dropped_lb, st_j.dropped_lb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6)
    assert st_t.steps == int(st_j.steps)
    np.testing.assert_array_equal(st_t.evaluated.numpy(),
                                  np.asarray(st_j.evaluated))
    np.testing.assert_array_equal(np.asarray(st_t.dropped),
                                  np.asarray(st_j.dropped))


@pytest.mark.parametrize("seed,mode", [(0, "plain"), (1, "clusters"),
                                       (2, "trimmed"),
                                       (3, "clustered_trimmed")])
def test_pooled_lut_matches_jax(seed, mode):
    p = _search_problem(seed)
    bj, bt = _backends(p["pct"], dtype=jnp.bfloat16)
    ns = p["pcs"].shape[0]
    src, kw_j, kw_t = p["pcs"], {}, {}
    if mode in ("clusters", "clustered_trimmed"):
        cl = jcoreset.build_weighted(jnp.asarray(p["pcs"]), size=64, seed=2)
        src = np.asarray(cl.reps)
        kw_j = dict(point_weights=cl.weights, point_deltas=cl.deltas)
        kw_t = dict(point_weights=T(cl.weights), point_deltas=T(cl.deltas))
    if mode in ("trimmed", "clustered_trimmed"):
        trim = dict(trim_keep=int(round(0.75 * ns)), trim_ns=ns)
        kw_j.update(trim)
        kw_t.update(trim)
    st_j = jpool.bnb_r3_pooled(
        bj, jnp.asarray(src), jnp.asarray(p["R2"]), jnp.asarray(p["spans2"]),
        jnp.asarray(p["fix2"]), jnp.float32(1e9), jnp.float32(1e-4),
        err_share_from=jnp.asarray(p["share"]), min_span=0.2, lanes=32,
        capacity=4096, max_steps=2000, **kw_j)
    before = (cuda_bounds.fused_bounds_lanes.launches,
              cuda_bounds.fused_bounds_lanes_trimmed.launches)
    st_t = tpool.bnb_r3_pooled(
        bt, T(src), T(p["R2"]), T(p["spans2"]), T(p["fix2"]),
        float(np.float32(1e9)), float(np.float32(1e-4)),
        err_share_from=T(p["share"]), min_span=0.2, lanes=32, capacity=4096,
        max_steps=2000, **kw_t)
    assert (cuda_bounds.fused_bounds_lanes.launches,
            cuda_bounds.fused_bounds_lanes_trimmed.launches) == before
    _assert_same_search(st_j, st_t)
    assert not st_t.active.any()
    assert np.all(st_t.evaluated.numpy() > 0)


@pytest.mark.parametrize("seed,trim", [(0, False), (1, True)])
def test_grouped_lut_matches_jax(seed, trim):
    p = _search_problem(seed)
    bj, bt = _backends(p["pct"])
    trim_keep = 150 if trim else None
    st_j = jfrontier.bnb_r3_batched(
        bj, jnp.asarray(p["pcs"]), jnp.asarray(p["R2"]),
        jnp.asarray(p["spans2"]), jnp.asarray(p["fix2"]), jnp.float32(1e9),
        jnp.float32(1e-4), min_span=0.2, batch=8, capacity=512,
        trim_keep=trim_keep)
    st_t = tfrontier.bnb_r3_batched(
        bt, T(p["pcs"]), T(p["R2"]), T(p["spans2"]), T(p["fix2"]),
        float(np.float32(1e9)), float(np.float32(1e-4)), min_span=0.2,
        batch=8, capacity=512, trim_keep=trim_keep)
    _assert_same_search(st_j, st_t)
    assert not st_t.active.any()
