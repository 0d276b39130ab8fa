"""The port's trimmed registration and grouped scheduler end to end:
`GoICP` and `register(Config)` through both packages on the pairs of the
JAX package's own tests (tests/test_goicp.py,
tests/test_source_clusters.py), and the trimmed source-cluster rule.

Both packages must certify; their SSEs may differ by up to sse_threshold
and R, t must agree within 1e-3 (tests/test_torch_goicp.py's rule: ICP
trajectories can part in the last bits).
"""
import dataclasses

import numpy as np
import pytest
import torch

from fgoicp_tpu.config import Config as JConfig
from fgoicp_tpu.models.goicp import GoICP as JGoICP, register as jregister
from fgoicp_tpu_torch import Config as TConfig, EngineConfig as TEngine
from fgoicp_tpu_torch import write_ply
from fgoicp_tpu_torch.models.goicp import GoICP as TGoICP, register as tregister
from fgoicp_tpu_torch.ops import cuda_bounds
from test_goicp import _make_problem, _surface_cloud
from util import STD_ENGINE, std_engine


def _t_engine(**overrides):
    return TEngine(**dataclasses.asdict(std_engine(**overrides)))


def _with_outliers():
    """test_goicp.py::test_trimmed_registration_with_outliers' pair."""
    pct, pcs, R_true, t_true = _make_problem(seed=4, angle=1.8, n=200)
    rng = np.random.default_rng(5)
    outliers = rng.uniform(-3, 3, size=(40, 3)).astype(np.float32)
    return pct, np.concatenate([pcs, outliers]), R_true, t_true


def _assert_same_solution(jm, tm, R_j, t_j, R_t, t_t, R_true, t_true,
                          pose_atol=1e-3):
    for m in (jm, tm):
        assert m.last_certified_gap <= m.sse_threshold
    assert jm.sse_threshold == tm.sse_threshold
    assert jm.trim_keep == tm.trim_keep
    assert abs(jm.best_sse - tm.best_sse) <= tm.sse_threshold
    np.testing.assert_allclose(R_t, R_j, atol=1e-3)
    np.testing.assert_allclose(t_t, t_j, atol=1e-3)
    np.testing.assert_allclose(R_t, R_true, atol=pose_atol)
    np.testing.assert_allclose(t_t, t_true, atol=pose_atol)


def _counters(m):
    s = m.stats
    return (s.rotation_children, s.translation_nodes, s.inner_loop_steps)


def _assert_close_counters(jm, tm):
    """The same outer search; translation nodes within 2 % (last-bit ICP
    differences can move an incumbent and with it the pruning)."""
    assert tm.stats.rotation_children == jm.stats.rotation_children
    assert abs(tm.stats.translation_nodes - jm.stats.translation_nodes) \
        <= 0.02 * jm.stats.translation_nodes


@pytest.mark.parametrize("backend", ["exact", "proxy"])
def test_trimmed_goicp_matches_jax(backend):
    pct, pcs, R_true, t_true = _with_outliers()
    kw = dict(mse_threshold=5e-4, bound_backend=backend, proxy_size=128,
              trim_fraction=0.25)
    jm = JGoICP(pct, pcs, engine=std_engine(), **kw)
    R_j, t_j = jm.run()
    before = (cuda_bounds.fused_bounds_lanes.launches,
              cuda_bounds.fused_bounds_lanes_trimmed.launches)
    tm = TGoICP(pct, pcs, engine=_t_engine(), device="cpu", **kw)
    R_t, t_t = tm.run()
    assert (cuda_bounds.fused_bounds_lanes.launches,
            cuda_bounds.fused_bounds_lanes_trimmed.launches) == before
    assert tm.trim_keep == int(round(240 * 0.75)) and tm.src_clusters is None
    # The trimmed lane kernel's source order, built once at set-up.
    assert torch.equal(tm._point_order, cuda_bounds.source_order(tm.pcs))
    # The JAX test's own recovery bound (outliers limit the fit).
    _assert_same_solution(jm, tm, R_j, t_j, R_t, t_t, R_true, t_true,
                          pose_atol=0.05)
    assert tm.stats.translation_nodes > 0
    _assert_close_counters(jm, tm)


def test_trimmed_goicp_with_explicit_clusters_matches_jax():
    """test_source_clusters.py::test_goicp_trimmed_with_clusters_recovers:
    an explicit source_coreset keeps clusters under trimming (member-level
    clustered trim)."""
    rng = np.random.default_rng(7)
    pct = _surface_cloud(rng, 400)
    c, s = np.cos(2.0), np.sin(2.0)
    R_true = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    t_true = np.array([0.2, -0.1, 0.15], np.float32)
    inliers = (pct[:240] - t_true) @ R_true
    outliers = rng.uniform(-1.2, 1.2, size=(60, 3)).astype(np.float32)
    pcs = np.concatenate([inliers, outliers])
    kw = dict(mse_threshold=2e-3, trim_fraction=0.25)
    jm = JGoICP(pct, pcs, engine=std_engine(source_coreset=96), **kw)
    R_j, t_j = jm.run()
    tm = TGoICP(pct, pcs, engine=_t_engine(source_coreset=96), device="cpu",
                **kw)
    assert tm.src_clusters is not None and tm.trim_keep is not None
    R_t, t_t = tm.run()
    _assert_same_solution(jm, tm, R_j, t_j, R_t, t_t, R_true, t_true,
                          pose_atol=5e-3)
    _assert_close_counters(jm, tm)


@pytest.mark.parametrize("trim", [False, True])
def test_grouped_goicp_matches_jax(trim):
    if trim:
        pct, pcs, R_true, t_true = _with_outliers()
        kw = dict(trim_fraction=0.25, bound_backend="exact")
    else:
        pct, pcs, R_true, t_true = _make_problem(angle=2.2)
        kw = dict(bound_backend="proxy", proxy_size=128)
    jm = JGoICP(pct, pcs, mse_threshold=5e-4,
                engine=std_engine(frontier_mode="grouped"), **kw)
    R_j, t_j = jm.run()
    before = cuda_bounds.fused_bounds.launches
    tm = TGoICP(pct, pcs, mse_threshold=5e-4,
                engine=_t_engine(frontier_mode="grouped"), device="cpu", **kw)
    R_t, t_t = tm.run()
    assert cuda_bounds.fused_bounds.launches == before
    _assert_same_solution(jm, tm, R_j, t_j, R_t, t_t, R_true, t_true,
                          pose_atol=0.05 if trim else 1e-3)
    assert tm.stats.translation_nodes > 0
    _assert_close_counters(jm, tm)


def test_register_trimmed_config_matches_jax(tmp_path):
    pct, pcs, R_true, t_true = _with_outliers()
    tgt, src = tmp_path / "target.ply", tmp_path / "source.ply"
    write_ply(str(tgt), pct)
    write_ply(str(src), pcs)
    engine = "\n".join(f"{k} = {str(v).lower() if isinstance(v, bool) else v}"
                       for k, v in STD_ENGINE.items())
    cfg = tmp_path / "run.toml"
    cfg.write_text(f'[io]\ntarget = "{tgt}"\nsource = "{src}"\n\n'
                   f'[params]\nmse_threshold = 5e-4\ntrim = true\n'
                   f'trim_fraction = 0.25\n\n[engine]\n{engine}\n')
    jm, R_j, t_j = jregister(JConfig.from_toml(str(cfg)), pct, pcs)
    tm, R_t, t_t = tregister(TConfig.from_toml(str(cfg)), pct, pcs,
                             device="cpu")
    assert tm.trim_keep == jm.trim_keep == 180
    _assert_same_solution(jm, tm, R_j, t_j, R_t, t_t, R_true, t_true,
                          pose_atol=0.05)


def test_trimmed_engine_builds_no_auto_clusters():
    """The automatic source-cluster rule skips trimmed engines (ns > 2048,
    source_coreset = -1); an untrimmed engine and an explicit
    source_coreset still build them — in both packages."""
    rng = np.random.default_rng(3)
    pct = _surface_cloud(rng, 300)
    pcs = _surface_cloud(rng, 2100)
    for make, engine in ((JGoICP, std_engine), (TGoICP, _t_engine)):
        kw = dict(proxy_size=64)
        if make is TGoICP:
            kw["device"] = "cpu"
        auto = engine(source_coreset=-1, icp_search_subsample=0)
        trimmed = make(pct, pcs, engine=auto, trim_fraction=0.2, **kw)
        assert trimmed.trim_keep == 1680 and trimmed.src_clusters is None
        plain = make(pct, pcs, engine=auto, **kw)
        assert plain.src_clusters is not None
        explicit = make(pct, pcs, trim_fraction=0.2, engine=engine(
            source_coreset=64, icp_search_subsample=0), **kw)
        assert explicit.src_clusters is not None
