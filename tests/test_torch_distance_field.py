"""Port parity: the distance field of the LUT backend
(fgoicp_tpu_torch/ops/distance_field.py) and the `minplus_1d` kernel's plain
version (ops/cuda_minplus.py) against the JAX package's
`ops/distance_field.py` and Pallas `minplus_1d` (interpret mode), on the same
seeded numpy inputs; then the soundness properties of
tests/test_distance_field.py on the port alone.

Tolerances: the min-plus plain version rounds c = (i - j) * res, c * c and
g + c * c separately, as distance_field._minplus_1d is written; XLA on the
CPU contracts the last two into a fused multiply-add, so the two differ by
at most an ulp (rtol 1e-6).  The Pallas kernel rounds diff * diff * res^2
(rtol 1e-5 / atol 1e-6, as JAX's own test holds it).  Builders: rtol 1e-5 /
atol 1e-6 in float32 (nearest-neighbour rounding); bfloat16 fields within one
bfloat16 step (2^-7 of the value's binade), since float32 values an ulp apart
can round to neighbouring bfloat16 values.  Lookups on a field carried across with
`field_from_numpy`: rtol 1e-6 / atol 1e-7.
"""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgoicp_tpu.ops import distance_field as jdf
from fgoicp_tpu.ops import pallas_minplus
from fgoicp_tpu_torch.ops import bounds as tbounds
from fgoicp_tpu_torch.ops import cuda_minplus
from fgoicp_tpu_torch.ops import distance_field as tdf
from fgoicp_tpu_torch.ops import geometry as tgeo
from fgoicp_tpu_torch.ops import nn as tnn

JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
              torch.float16: jnp.float16}


def _bounds(pts):
    return np.stack([pts.min(0), pts.max(0)], axis=-1)


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(0)
    return rng.uniform(-0.5, 0.5, size=(200, 3)).astype(np.float32)


def _carried(fj):
    """The JAX field's arrays as the port's field."""
    return tdf.field_from_numpy(np.asarray(fj.values), np.asarray(fj.origin),
                                np.asarray(fj.inv_res),
                                np.asarray(fj.assign_delta),
                                np.asarray(fj.quant_eps), "cpu")


def _true_dist(q, cloud):
    d2 = tnn.nearest_sqdist(torch.from_numpy(q), torch.from_numpy(cloud))
    return np.sqrt(d2.numpy()).reshape(q.shape[:-1])


# ---------------------------------------------------------------------------
# Grid dims and the memory budget
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bounds,res,inclusive", [
    ([[0, 1.0], [0, 0.5], [0, 0.25]], 0.1, True),
    ([[0, 1.0], [0, 0.5], [0, 0.25]], 0.1, False),
    ([[-0.93, 1.07], [-0.61, 0.66], [-0.41, 0.38]], 0.002, True),
    ([[-0.93, 1.07], [-0.61, 0.66], [-0.41, 0.38]], 0.05, False),
    ([[0, 0.01], [0, 0.01], [0, 0.01]], 0.1, True),
])
def test_grid_dims_match_jax(bounds, res, inclusive):
    b = np.asarray(bounds, np.float64)
    assert tdf.grid_dims(b, res, inclusive=inclusive) == \
        jdf.grid_dims(b, res, inclusive=inclusive)


def test_grid_dims_limits_match_jax():
    b = np.array([[0, 1.0], [0, 0.5], [0, 0.25]], np.float64)
    for mod in (tdf, jdf):
        with pytest.raises(ValueError, match="exceed the limit"):
            mod.grid_dims(b, 1e-5)
    # 1301^3 cells pass the per-axis cap but wrap an int32 flat index.
    b = np.array([[0, 1.3], [0, 1.3], [0, 1.3]], np.float64)
    for mod in (tdf, jdf):
        with pytest.raises(ValueError, match="2\\^31"):
            mod.grid_dims(b, 1e-3)


@pytest.mark.parametrize("dims,dtype,builder", [
    ((1000, 1000, 1000), torch.bfloat16, "edt"),
    ((960, 946, 741), torch.float32, "edt"),
    ((2000, 2000, 2000), torch.float32, "edt"),
    ((1500, 1500, 1500), torch.float16, "brute"),
    ((300, 200, 100), torch.float32, "ref"),
])
def test_check_memory_budget_matches_jax(dims, dtype, builder):
    budget = 16 * 1024 ** 3
    try:
        want = jdf.check_memory_budget(dims, JAX_DTYPES[dtype], builder,
                                       hbm_budget=budget)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            tdf.check_memory_budget(dims, dtype, builder, hbm_budget=budget)
        assert str(got.value) == str(err)
        return
    assert tdf.check_memory_budget(dims, dtype, builder,
                                   hbm_budget=budget) == want


def test_memory_budget_defaults_and_build_guard(cloud):
    # On the CPU both packages fall back to the same 16 GiB budget.
    assert tdf.device_memory_budget("cpu") == 16 * 1024 ** 3
    assert tdf.device_memory_budget() == 16 * 1024 ** 3
    with pytest.raises(ValueError, match="coarser"):
        tdf.build(torch.from_numpy(cloud), _bounds(cloud), 0.1,
                  builder="edt", hbm_budget=1024)


# ---------------------------------------------------------------------------
# Min-plus
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,res,chunks", [
    ((37, 23), 0.13, (1024, 128)),
    ((37, 23), 0.13, (5, 8)),
    ((300, 61), 0.02, (64, 16)),
    ((3, 1), 0.5, (1, 1)),
])
def test_minplus_plain_matches_jax(shape, res, chunks):
    rng = np.random.default_rng(7)
    g = rng.uniform(0, 4.0, size=shape).astype(np.float32)
    g[0] = tdf.BIG  # an unseeded line
    want = np.asarray(jdf._minplus_1d(jnp.asarray(g), jnp.float32(res)))
    lc, oc = chunks
    got = cuda_minplus.minplus_1d_plain(torch.from_numpy(g), res,
                                        out_chunk=oc, line_chunk=lc).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # The rounding the kernel reproduces: each operation on its own.
    n = shape[1]
    x = ((np.arange(n, dtype=np.float32)[None, :]
          - np.arange(n, dtype=np.float32)[:, None]) * np.float32(res))
    exact = np.min(g[:, :, None] + (x * x)[None], axis=1)
    np.testing.assert_array_equal(got, exact)


@pytest.mark.parametrize("shape", [(5, 17), (40, 130)])
def test_minplus_plain_matches_pallas_interpret(shape):
    rng = np.random.default_rng(9)
    g = rng.uniform(0, 4.0, size=shape).astype(np.float32)
    want = np.asarray(pallas_minplus.minplus_1d(jnp.asarray(g), 0.07,
                                                interpret=True))
    got = cuda_minplus.minplus_1d_plain(torch.from_numpy(g), 0.07).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_minplus_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(3)
    before = cuda_minplus.minplus_1d.launches
    for shape in [(1, 1), (7, 47), (33, 130)]:
        g = torch.from_numpy(rng.uniform(0, 2.0, size=shape).astype(np.float32))
        g[-1] = tdf.BIG
        got = cuda_minplus.minplus_1d(g, 0.031)
        assert torch.equal(got, cuda_minplus.minplus_1d_plain(g, 0.031))
        assert bool(torch.all(got[-1] >= tdf.BIG))
    assert cuda_minplus.minplus_1d.launches == before
    with pytest.raises(TypeError, match="float32"):
        cuda_minplus.minplus_1d(torch.zeros(3, 4, dtype=torch.float64), 0.1)
    with pytest.raises(ValueError, match=r"\[L, n\]"):
        cuda_minplus.minplus_1d(torch.zeros(3), 0.1)


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("builder", ["brute", "edt", "ref", "auto"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_build_matches_jax(cloud, builder, dtype):
    res = 0.05
    fj = jdf.build(cloud, _bounds(cloud), res, builder=builder,
                   dtype=JAX_DTYPES[dtype])
    ft = tdf.build(torch.from_numpy(cloud), _bounds(cloud), res,
                   builder=builder, dtype=dtype)
    assert ft.values.dtype == dtype
    assert ft.dims == tuple(fj.values.shape)
    assert ft.builder == ("brute" if builder == "auto" else builder)
    for name in ("origin", "inv_res", "assign_delta", "quant_eps"):
        np.testing.assert_array_equal(getattr(ft, name).numpy(),
                                      np.asarray(getattr(fj, name)))
    got = ft.values.float().numpy()
    want = np.asarray(fj.values).astype(np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        # One bfloat16 step: 2^-7 of the binade of the larger value.
        big = np.maximum(np.abs(got), np.abs(want))
        step = 2.0 ** (np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
        assert np.all(np.abs(got - want) <= step)
        assert np.mean(got != want) < 0.01


def test_edt_matches_jax_on_an_anisotropic_grid():
    """The three passes in JAX's order on a grid whose axes differ (so the
    permutes matter), with a cloud whose points fall between nodes."""
    rng = np.random.default_rng(12)
    pts = (rng.uniform(-1, 1, size=(150, 3))
           * np.array([0.9, 0.4, 0.2])).astype(np.float32)
    fj = jdf.build(pts, _bounds(pts), 0.04, builder="edt")
    ft = tdf.build(torch.from_numpy(pts), _bounds(pts), 0.04, builder="edt")
    assert len(set(ft.dims)) == 3
    np.testing.assert_allclose(ft.values.numpy(), np.asarray(fj.values),
                               rtol=1e-5, atol=1e-6)


def test_edt_within_slack_of_brute(cloud):
    res = 0.05
    b = tdf.build(torch.from_numpy(cloud), _bounds(cloud), res,
                  builder="brute")
    e = tdf.build(torch.from_numpy(cloud), _bounds(cloud), res, builder="edt")
    assert float(e.slack) == pytest.approx(np.sqrt(1.5) * res)
    assert float((b.values - e.values).abs().max()) <= float(e.slack) + 1e-5


def test_edt_zero_at_seeded_nodes():
    pts = torch.tensor([[0.0, 0.0, 0.0], [0.2, 0.2, 0.2]])
    bounds = np.array([[0, 0.2], [0, 0.2], [0, 0.2]], np.float64)
    f = tdf.build(pts, bounds, 0.1, builder="edt")
    assert float(f.values[0, 0, 0]) == pytest.approx(0.0, abs=1e-6)
    assert float(f.values[2, 2, 2]) == pytest.approx(0.0, abs=1e-6)
    assert float(f.values[1, 0, 0]) == pytest.approx(0.1, abs=1e-5)


# ---------------------------------------------------------------------------
# Lookups on a field carried across from JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("builder,dtype", [
    ("brute", jnp.float32), ("edt", jnp.float32), ("edt", jnp.bfloat16),
    ("ref", jnp.float32)])
def test_lookups_match_jax(cloud, builder, dtype):
    fj = jdf.build(cloud, _bounds(cloud), 0.07, builder=builder, dtype=dtype)
    ft = _carried(fj)
    rng = np.random.default_rng(4)
    # In the box, and far out of it (clamped to the border).
    q = np.concatenate([rng.uniform(-0.45, 0.45, size=(6, 40, 3)),
                        rng.uniform(-2.0, 2.0, size=(6, 40, 3))],
                       axis=1).astype(np.float32)
    qt, qj = torch.from_numpy(q), jnp.asarray(q)
    fns = [("lookup", tdf.lookup, jdf.lookup),
           ("lookup_nearest", tdf.lookup_nearest, jdf.lookup_nearest),
           ("box_excess", tdf.box_excess, jdf.box_excess),
           ("lookup_ref_compat", tdf.lookup_ref_compat,
            jdf.lookup_ref_compat)]
    for name, t_fn, j_fn in fns:
        got, want = t_fn(ft, qt), np.asarray(j_fn(fj, qj))
        assert got.shape == want.shape == (6, 80), name
        assert got.dtype == torch.float32, name
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def test_lookup_interpolates_and_clamps():
    pts = torch.tensor([[0.0, 0.0, 0.0]])
    bounds = np.array([[0, 0.4], [0, 0.4], [0, 0.4]], np.float64)
    f = tdf.build(pts, bounds, 0.1, builder="brute")
    assert float(tdf.lookup(f, torch.tensor([[0.15, 0.0, 0.0]]))[0]) == \
        pytest.approx(0.15, abs=1e-5)
    far = tdf.lookup(f, torch.tensor([[100.0, 100.0, 100.0]]))
    corner = tdf.lookup(f, torch.tensor([[0.4, 0.4, 0.4]]))
    assert float(far[0]) == pytest.approx(float(corner[0]), abs=1e-5)
    assert float(tdf.box_excess(f, torch.tensor([[0.4, 0.4, 1.4]]))[0]) == \
        pytest.approx(1.0, abs=1e-5)


# ---------------------------------------------------------------------------
# Soundness of the conservative LUT estimates (the port alone)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("builder,dtype,lo,hi", [
    ("edt", torch.float32, -0.7, 0.7),
    ("edt", torch.float32, -2.0, 2.0),     # far out of the box
    ("brute", torch.bfloat16, -0.6, 0.6),
    ("edt", torch.bfloat16, -2.0, 2.0),
])
def test_conservative_estimates_bracket_truth(cloud, builder, dtype, lo, hi):
    f = tdf.build(torch.from_numpy(cloud), _bounds(cloud), 0.07,
                  builder=builder, dtype=dtype)
    be = tbounds.make_backend(torch.from_numpy(cloud), kind="lut", field=f)
    assert be.conservative and be.lookup == "nearest"
    rng = np.random.default_rng(3)
    q = rng.uniform(lo, hi, size=(512, 3)).astype(np.float32)
    d_ub, d_lb = tbounds.distance_estimates(be, torch.from_numpy(q))
    true = _true_dist(q, cloud)
    assert np.all(d_lb.numpy() <= true + 1e-5)
    assert np.all(d_ub.numpy() >= true - 1e-5)
    far = np.linalg.norm(q, axis=-1) > 1.5
    if far.any():
        # Beyond the box the lower estimate beats the border distance the
        # reference's texture clamp returns.
        assert d_lb.numpy()[far].min() > float(
            tdf.lookup(f, torch.from_numpy(q)).max())


def test_lut_node_bounds_bracket_true_sse(cloud):
    rng = np.random.default_rng(5)
    pcs = torch.from_numpy(rng.uniform(-0.4, 0.4, size=(50, 3))
                           .astype(np.float32))
    tgt = torch.from_numpy(cloud)
    f = tdf.build(tgt, _bounds(cloud), 0.07, builder="edt")
    be = tbounds.make_backend(tgt, kind="lut", field=f)
    exact = tbounds.make_backend(tgt, kind="exact")
    R = tgeo.quat_cube_to_matrix(torch.from_numpy(
        rng.uniform(-0.4, 0.4, size=(6, 3)).astype(np.float32)))
    spans = torch.full((6,), 0.2)
    fix = torch.tensor([True, False, True, False, True, False])
    tc = torch.from_numpy(rng.uniform(-0.3, 0.3, size=(6, 4, 3))
                          .astype(np.float32))
    lb, ub = tbounds.evaluate_bounds(be, pcs, R, spans, fix, tc,
                                     torch.full((6, 4), 0.15))
    _, sse = tbounds.evaluate_bounds(exact, pcs, R, spans,
                                     torch.ones(6, dtype=torch.bool), tc,
                                     torch.zeros(6, 4))
    assert bool(torch.all(lb <= sse + 1e-5))
    assert bool(torch.all(lb <= ub))


def test_field_modules_never_load_jax():
    code = ("import sys, fgoicp_tpu_torch.ops.distance_field, "
            "fgoicp_tpu_torch.ops.cuda_minplus; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'fgoicp_tpu' not in sys.modules, 'fgoicp_tpu imported'")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
