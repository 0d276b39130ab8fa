"""The LUT bound backend end to end: `GoICP(..., bound_backend="lut")`
through both packages on the `tests/test_goicp.py::_make_problem` pairs at
lut_resolution 0.05, with the JAX package's LUT engines
(tests/test_goicp.py::test_lut_backend_end_to_end, ::test_ref_compat_lut_end_to_end,
tests/test_config_matrix.py host-pooled-lut and host-pooled-lut-trim), plus
the exact-EDT builder and the grouped scheduler.

Both packages must certify with SSEs within sse_threshold; R and t must agree
within 1e-3 of each other and of the ground truth (2e-3 in ref-compat mode,
as JAX's own test).  Both build the same field (brute at this size, unless
the engine asks for the EDT), so the searches bound the same nodes: equal
rotation_children, translation_nodes within 2 %.
"""
import dataclasses

import numpy as np
import pytest

from fgoicp_tpu.models.goicp import GoICP as JGoICP
from fgoicp_tpu_torch import EngineConfig as TEngine
from fgoicp_tpu_torch.models.goicp import GoICP as TGoICP
from fgoicp_tpu_torch.ops import bounds as tbounds
from fgoicp_tpu_torch.ops import cuda_minplus
from test_goicp import _make_problem
from util import std_engine

CASES = {
    # name: (seed, angle, engine overrides, trim_fraction, pose atol)
    "conservative": (7, 1.7, {}, 0.0, 1e-3),
    "ref_compat": (8, 1.6, dict(ref_compat_lut=True), 0.0, 2e-3),
    "trimmed": (4, 1.8, {}, 0.2, 1e-3),
    "edt_float32": (7, 1.7, dict(lut_builder="edt", lut_dtype="float32"),
                    0.0, 1e-3),
    "grouped": (7, 1.7, dict(frontier_mode="grouped"), 0.0, 1e-3),
}


@pytest.mark.parametrize("name", list(CASES))
def test_lut_goicp_matches_jax(name):
    seed, angle, eng, trim, atol = CASES[name]
    pct, pcs, R_true, t_true = _make_problem(seed=seed, angle=angle)
    kw = dict(lut_resolution=0.05, mse_threshold=5e-4, bound_backend="lut",
              trim_fraction=trim)
    jm = JGoICP(pct, pcs, engine=std_engine(**eng), **kw)
    R_j, t_j = jm.run()
    before = cuda_minplus.minplus_1d.launches
    tm = TGoICP(pct, pcs, engine=TEngine(**dataclasses.asdict(
        std_engine(**eng))), device="cpu", **kw)
    R_t, t_t = tm.run()
    assert cuda_minplus.minplus_1d.launches == before  # CPU: plain version
    be = tm.backend
    assert isinstance(be, tbounds.LutBackend)
    assert (be.conservative, be.ref_compat, be.lookup) == (
        jm.backend.conservative, jm.backend.ref_compat, jm.backend.lookup)
    assert be.field.dims == tuple(jm.backend.field.values.shape)
    assert be.field.builder == eng.get(
        "lut_builder", "ref" if eng.get("ref_compat_lut") else "brute")
    for m in (jm, tm):
        assert m.last_certified_gap <= m.sse_threshold
    assert abs(jm.best_sse - tm.best_sse) <= tm.sse_threshold
    for got, want in ((R_t, R_j), (R_t, R_true)):
        np.testing.assert_allclose(got, want, atol=atol)
    for got, want in ((t_t, t_j), (t_t, t_true)):
        np.testing.assert_allclose(got, want, atol=atol)
    assert tm.stats.rotation_children == jm.stats.rotation_children
    assert tm.stats.translation_nodes > 0
    assert abs(tm.stats.translation_nodes - jm.stats.translation_nodes) \
        <= 0.02 * jm.stats.translation_nodes


@pytest.mark.parametrize("ref_compat", [False, True])
def test_lut_engine_search_icp_target(ref_compat):
    """A LUT engine builds the search ICPs' proxy coreset on the side, as
    JAX does, except in ref-compat mode."""
    pct, pcs, _, _ = _make_problem(seed=2, angle=0.4)
    kw = dict(lut_resolution=0.1, bound_backend="lut", proxy_size=64)
    eng = std_engine(ref_compat_lut=ref_compat)
    jm = JGoICP(pct, pcs, engine=eng, **kw)
    tm = TGoICP(pct, pcs, engine=TEngine(**dataclasses.asdict(eng)),
                device="cpu", **kw)
    if ref_compat:
        assert tm._icp_search_target is None and jm._icp_search_target is None
    else:
        # The same FPS points of the normalized target (normalization
        # rounds in another order: an ulp apart).
        np.testing.assert_allclose(tm._icp_search_target.numpy(),
                                   np.asarray(jm._icp_search_target),
                                   rtol=0, atol=1e-6)


def test_lut_engine_refuses_oversized_fields():
    pct, pcs, _, _ = _make_problem(seed=2, angle=0.4)
    with pytest.raises(ValueError, match="exceed the limit"):
        TGoICP(pct, pcs, lut_resolution=1e-4, bound_backend="lut",
               device="cpu")
