"""The ported slice end to end: `register(Config)` and `GoICP` through both
packages on the `tests/test_goicp.py::_make_problem` pairs, the device outer
loop on the config matrix's device rows (`tests/test_config_matrix.py`) and
on an overflowing SO(3) frontier, the CLI (with --resume and
--debug-checks), and the port's import and device rules.

Both packages must certify (or both report the same open gap).  Their SSEs
may differ by up to sse_threshold: the JAX CPU path ranks neighbours by
norm expansion plus an exact rescore, the port by direct differences, so
ICP trajectories can part in the last bits.  R and t must agree within
1e-3 of each other and of the ground truth.
"""
import dataclasses
import subprocess
import sys
import tomllib

import numpy as np
import pytest
import torch

from fgoicp_tpu.config import Config as JConfig
from fgoicp_tpu.models.goicp import GoICP as JGoICP, register as jregister
from fgoicp_tpu_torch import Config as TConfig, EngineConfig as TEngine
from fgoicp_tpu_torch import write_ply
from fgoicp_tpu_torch.__main__ import run as cli_run
from fgoicp_tpu_torch.models.goicp import GoICP as TGoICP, register as tregister
from fgoicp_tpu_torch.utils import sanitize as tsanitize
from test_checkpoint import _pair
from test_config_matrix import COMBOS, _problem
from test_goicp import _make_problem, _surface_cloud
from util import STD_ENGINE, std_engine


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path runs many tiny ops: on one thread a test worker
    does not oversubscribe the cores that the other workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t_engine(**overrides):
    return TEngine(**dataclasses.asdict(std_engine(**overrides)))


def _write_config(tmp_path, pct, pcs, output="", **extra):
    tgt, src = tmp_path / "target.ply", tmp_path / "source.ply"
    write_ply(str(tgt), pct)
    write_ply(str(src), pcs)
    engine = "\n".join(
        f"{k} = {str(v).lower() if isinstance(v, bool) else repr(v)}"
        for k, v in dict(STD_ENGINE, **extra).items())
    cfg = tmp_path / "run.toml"
    cfg.write_text(f'[io]\ntarget = "{tgt}"\nsource = "{src}"\n'
                   f'output = "{output}"\n\n[params]\nmse_threshold = 5e-4\n'
                   f'source_subsample = 0.5\n\n[engine]\n{engine}\n')
    return cfg


def _assert_same_solution(jm, tm, R_j, t_j, R_t, t_t, R_true, t_true):
    for m in (jm, tm):
        assert m.last_certified_gap <= m.sse_threshold
    assert jm.sse_threshold == tm.sse_threshold
    assert abs(jm.best_sse - tm.best_sse) <= tm.sse_threshold
    np.testing.assert_allclose(R_t, R_j, atol=1e-3)
    np.testing.assert_allclose(t_t, t_j, atol=1e-3)
    np.testing.assert_allclose(R_t, R_true, atol=1e-3)
    np.testing.assert_allclose(t_t, t_true, atol=1e-3)


def test_register_from_config_matches_jax(tmp_path):
    pct, pcs, R_true, t_true = _make_problem(seed=0, angle=2.2)
    cfg = _write_config(tmp_path, pct, pcs)
    jm, R_j, t_j = jregister(JConfig.from_toml(str(cfg)))
    tm, R_t, t_t = tregister(TConfig.from_toml(str(cfg)), device="cpu")
    # source_subsample 0.5 (the reference clamp) keeps the same points.
    assert tm.ns == jm.ns <= len(pcs) // 2
    _assert_same_solution(jm, tm, R_j, t_j, R_t, t_t, R_true, t_true)
    assert tm.stats.translation_nodes > 0


@pytest.mark.parametrize("backend", ["exact", "proxy"])
def test_goicp_matches_jax_on_large_rotation(backend):
    pct, pcs, R_true, t_true = _make_problem(angle=2.2)
    jm = JGoICP(pct, pcs, mse_threshold=5e-4, engine=std_engine(),
                bound_backend=backend, proxy_size=128)
    R_j, t_j = jm.run()
    tm = TGoICP(pct, pcs, mse_threshold=5e-4, engine=_t_engine(),
                bound_backend=backend, proxy_size=128, device="cpu")
    R_t, t_t = tm.run()
    _assert_same_solution(jm, tm, R_j, t_j, R_t, t_t, R_true, t_true)
    # The same search, node for node, up to last-bit ICP differences.
    assert tm.stats.rotation_children == jm.stats.rotation_children
    assert abs(tm.stats.translation_nodes - jm.stats.translation_nodes) \
        <= 0.02 * jm.stats.translation_nodes
    # Getters of the reference surface.
    assert tm.get_best_error() == tm.best_sse
    R, t = tm.get_best_transform()
    lR, lt = tm.get_last_transform()
    assert R.shape == (3, 3) and t.shape == (3,)
    assert lR.shape == (3, 3) and lt.shape == (3,)
    sses = [h[1] for h in tm.history]
    assert all(b <= a + 1e-6 for a, b in zip(sses, sses[1:]))


def test_world_frame_restoration():
    pct, pcs, _, _ = _make_problem(seed=1, angle=1.5)
    pct_w = pct * 37.0 + np.array([100.0, -50.0, 3.0], np.float32)
    pcs_w = pcs * 37.0 + np.array([-8.0, 2.0, 77.0], np.float32)
    m = TGoICP(pct_w, pcs_w, mse_threshold=5e-4, engine=_t_engine(),
               bound_backend="exact", device="cpu")
    R, t = m.run()
    mapped = pcs_w @ np.asarray(R).T + np.asarray(t)
    rmse = np.sqrt(np.mean(np.sum((mapped - pct_w) ** 2, axis=1)))
    assert rmse < 37.0 * 0.02


def test_exhaustion_reports_open_gap_like_jax():
    """An unreachable threshold exhausts the finite rotation tree; closed
    terminal leaves whose lb still claims an improvement must hold the
    certificate gap open in both packages."""
    rng = np.random.default_rng(21)
    pct = _surface_cloud(rng, 160)
    c, s = np.cos(1.3), np.sin(1.3)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    pcs = ((pct[:120] - 0.1) @ R
           + rng.normal(scale=0.02, size=(120, 3))).astype(np.float32)
    kw = dict(rotation_min_span=0.3, icp_trigger_factor=1.8,
              icp_multi_start=False)
    jm = JGoICP(pct, pcs, mse_threshold=1e-9, engine=std_engine(**kw),
                bound_backend="exact")
    jm.run()
    tm = TGoICP(pct, pcs, mse_threshold=1e-9, engine=_t_engine(**kw),
                bound_backend="exact", device="cpu")
    tm.run()
    for m in (jm, tm):
        assert m.last_certified_gap > m.sse_threshold
        assert m.best_sse < 1e10
    np.testing.assert_allclose(tm.best_sse, jm.best_sse, rtol=1e-3)


def test_cli_writes_result_toml(tmp_path):
    pct, pcs, R_true, t_true = _make_problem(seed=0, angle=2.2)
    out = tmp_path / "result.toml"
    cfg = _write_config(tmp_path, pct, pcs, output=str(out))
    proc = subprocess.run(
        [sys.executable, "-m", "fgoicp_tpu_torch", "-c", str(cfg),
         "--device", "cpu"], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    result = tomllib.load(open(out, "rb"))
    np.testing.assert_allclose(np.asarray(result["result"]["rotation"]),
                               R_true, atol=1e-3)
    np.testing.assert_allclose(result["result"]["translation"], t_true,
                               atol=1e-3)
    assert result["result"]["mse"] < 5e-4
    assert result["stats"]["translation_nodes"] > 0


def test_cli_device_cuda_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pct, pcs, _, _ = _make_problem(seed=3, angle=1.0)
    cfg = _write_config(tmp_path, pct, pcs)
    with pytest.raises(RuntimeError, match="cuda"):
        cli_run(["-c", str(cfg), "--device", "cuda"])


def test_import_never_loads_jax():
    code = ("import sys, fgoicp_tpu_torch, fgoicp_tpu_torch.__main__; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'fgoicp_tpu' not in sys.modules, 'fgoicp_tpu imported'")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# The ids are those the cases had beside the cases that went with the code
# they tested: the serving hand-offs (tests/test_torch_serving.py), the
# device outer loop, checkpoints and debug_checks (the device rows, the
# overflow and the CLI cases below, tests/test_torch_so3_frontier.py,
# test_torch_checkpoint.py and test_torch_sanitize.py).
@pytest.mark.parametrize("kw,item", [
    (dict(engine=dict(pool_update="merge")), "item 7"),
    (dict(engine=dict(mesh_cubes=2)), "item 16"),
], ids=["kw1-item 7", "kw2-item 16"])
def test_unported_options_name_their_roadmap_item(kw, item):
    pct, pcs, _, _ = _make_problem(seed=13, angle=0.5)
    kw = dict(kw)
    engine = _t_engine(**kw.pop("engine", {}))
    with pytest.raises(NotImplementedError, match=item):
        TGoICP(pct, pcs, engine=engine, device="cpu", **kw)


def test_unknown_options_raise_value_error():
    pct, pcs, _, _ = _make_problem(seed=13, angle=0.5)
    with pytest.raises(ValueError, match="outer_mode"):
        TGoICP(pct, pcs, engine=_t_engine(outer_mode="banana"), device="cpu")
    with pytest.raises(ValueError, match="backend"):
        TGoICP(pct, pcs, engine=_t_engine(), bound_backend="banana",
               device="cpu")
    with pytest.raises(ValueError, match=r"\[N, 3\]"):
        TGoICP(pct[:, :2], pcs, device="cpu")


def test_refuses_tf32_geometry():
    pct, pcs, _, _ = _make_problem(seed=13, angle=0.5)
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    old_prec = torch.get_float32_matmul_precision()
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32=True"):
            TGoICP(pct, pcs, engine=_t_engine(), device="cpu")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="precision='high'"):
            TGoICP(pct, pcs, engine=_t_engine(), device="cpu")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_tf32
        torch.set_float32_matmul_precision(old_prec)


DEVICE_ROWS = [c for c in COMBOS if c[1] == "device" and len(c) == 6]


@pytest.mark.parametrize("combo", DEVICE_ROWS, ids=[c[0] for c in DEVICE_ROWS])
def test_device_outer_loop_matches_jax_on_the_config_matrix(combo):
    """The config matrix's device rows (tests/test_config_matrix.py) through
    both packages: each certifies and recovers the known pose; R and t agree
    with JAX's at atol 2e-3 and best_sse at rtol 1e-4 (atol 1e-9: the
    exact-subset optimum is ~1e-12, float32 noise)."""
    label, _, _, backend, coreset, trim = combo
    pct, pcs, R_true, t_true = _problem()
    kw = dict(outer_mode="device", source_coreset=coreset, so3_capacity=2048)
    common = dict(mse_threshold=5e-4, bound_backend=backend, proxy_size=64,
                  lut_resolution=0.05, trim_fraction=trim)
    jm = JGoICP(pct, pcs, engine=std_engine(**kw), **common)
    R_j, t_j = jm.run()
    tm = TGoICP(pct, pcs, engine=_t_engine(**kw), device="cpu", **common)
    R_t, t_t = tm.run()
    for m, R, t in ((jm, R_j, t_j), (tm, R_t, t_t)):
        assert m.last_certified_gap <= m.sse_threshold * 1.0001, label
        np.testing.assert_allclose(np.asarray(R), R_true, atol=2e-3)
        np.testing.assert_allclose(np.asarray(t), t_true, atol=2e-3)
    np.testing.assert_allclose(R_t, np.asarray(R_j), atol=2e-3)
    np.testing.assert_allclose(t_t, np.asarray(t_j), atol=2e-3)
    np.testing.assert_allclose(tm.best_sse, jm.best_sse, rtol=1e-4,
                               atol=1e-9)
    assert tm.stats.outer_steps == jm.stats.outer_steps >= 1


def test_device_overflow_recertifies_like_jax():
    """so3_capacity = 8 * rotation_batch: the device frontier spills, the
    device gap ends open in both packages, the host loop re-certifies from
    the device incumbent, and both close the gap at the same optimum.  One
    ICP lane of four per step (icp_refine_best off, the reference's 1.8
    trigger, 10 iterations) keeps the device search from finding the optimum
    at its first step; a coarser translation_min_span (0.4) halves the inner
    nodes of its 31 outer steps."""
    pct, pcs = _pair()
    kw = dict(outer_mode="device", so3_capacity=16, icp_width=4,
              icp_refine_best=False, icp_trigger_factor=1.8, icp_max_iter=10,
              translation_min_span=0.4)
    runs = []
    for make, engine, extra in ((JGoICP, std_engine, {}),
                                (TGoICP, _t_engine, dict(device="cpu"))):
        m = make(pct, pcs, mse_threshold=5e-4, proxy_size=64,
                 engine=engine(**kw), **extra)
        device_gaps = []
        real_seed = m.seed_heap

        def seed_heap(m=m, real=real_seed, gaps=device_gaps):
            gaps.append(m.last_certified_gap)
            return real()

        m.seed_heap = seed_heap
        m.run()
        runs.append((m, device_gaps))
    (jm, j_gaps), (tm, t_gaps) = runs
    assert len(j_gaps) == len(t_gaps) == 1
    assert t_gaps[0] > tm.sse_threshold and j_gaps[0] > jm.sse_threshold
    np.testing.assert_allclose(t_gaps[0], j_gaps[0], rtol=1e-4)
    for m in (jm, tm):
        assert m.last_certified_gap <= m.sse_threshold
    np.testing.assert_allclose(tm.best_sse, jm.best_sse, rtol=1e-4,
                               atol=1e-9)
    assert tm.stats.outer_steps == jm.stats.outer_steps


def test_cli_resume_and_debug_checks(tmp_path, monkeypatch):
    """--debug-checks runs the sanitizer; --resume loads
    engine.checkpoint_path when it exists and finishes from it."""
    pct, pcs, R_true, t_true = _make_problem(seed=0, angle=2.2)
    ckpt_path = tmp_path / "bnb.npz"
    out = tmp_path / "result.toml"
    cfg = _write_config(tmp_path, pct, pcs, output=str(out),
                        checkpoint_path=str(ckpt_path), checkpoint_every=1)
    checks, loads = [], []
    real_check, real_load = tsanitize.check_heap, TGoICP.load_checkpoint

    def check_heap(heap, *args):
        checks.append(1)
        return real_check(heap, *args)

    def load_checkpoint(self, path):
        loads.append(path)
        return real_load(self, path)

    monkeypatch.setattr(tsanitize, "check_heap", check_heap)
    monkeypatch.setattr(TGoICP, "load_checkpoint", load_checkpoint)
    args = ["-c", str(cfg), "--device", "cpu"]
    assert cli_run(args + ["--resume", "--debug-checks"]) == 0
    assert checks and not loads   # nothing to resume yet
    assert ckpt_path.exists()
    first = tomllib.load(open(out, "rb"))["result"]
    n_checks = len(checks)
    assert cli_run(args + ["--resume"]) == 0
    assert loads == [str(ckpt_path)] and len(checks) == n_checks
    result = tomllib.load(open(out, "rb"))["result"]
    np.testing.assert_allclose(np.asarray(result["rotation"]), R_true,
                               atol=1e-3)
    np.testing.assert_allclose(result["translation"], t_true, atol=1e-3)
    assert result["mse"] < 5e-4
    np.testing.assert_allclose(result["sse"], first["sse"], rtol=1e-3,
                               atol=1e-9)
