"""Port parity: the serving mode (fgoicp_tpu_torch/models/serving.py) and
GoICP's two serving hand-offs against the JAX package, on
`tests/test_serving.py`'s problems (`_surface(400)`, 4 pairs x 80 points),
plus the port's own rules (device, mesh, input checks, the CLI's --serve).

Tolerances: `_seed_pairs` sse rtol 1e-4 (+1e-7 absolute, for pairs that fit
exactly), R and t atol 1e-4, scale and mu_s rtol 1e-6, and the same winning
start per pair; `GoICP` the same certificate verdict, best_sse within
sse_threshold, equal rotation_children and icp_runs; `register` per pair the
same certified / fallback_used, R and t atol 1e-3, equal ServiceStats
counts.  Both sides take exact-NN correspondences; JAX's CPU path ranks by
norm expansion and rescores the winner, so ICP trajectories can part in the
last bits.

Two faults of the JAX module are not mirrored (ROADMAP Queue 3), and no
test here pins them: a single [ns, 3] ndarray is one pair (JAX splits it
into rows, so its fallback gets a 3-vector), and a generator of sources is
read once.
"""
import dataclasses
import subprocess
import sys
import tomllib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgoicp_tpu.models import goicp as jgoicp
from fgoicp_tpu.models import icp as jicp
from fgoicp_tpu.models import serving as jserving
from fgoicp_tpu.models.goicp import GoICP as JGoICP
from fgoicp_tpu.ops import coreset as jcoreset
from fgoicp_tpu_torch import EngineConfig as TEngine
from fgoicp_tpu_torch import write_ply
from fgoicp_tpu_torch.__main__ import run as cli_run
from fgoicp_tpu_torch.models import icp as ticp
from fgoicp_tpu_torch.models import serving as tserving
from fgoicp_tpu_torch.models.goicp import GoICP as TGoICP
from fgoicp_tpu_torch.ops import coreset as tcoreset
from test_serving import _make_pairs, _rot, _surface
from util import std_engine

MULTI = dict(icp_multi_start=True)


def _t_engine(**overrides):
    return TEngine(**dataclasses.asdict(std_engine(**overrides)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path runs many tiny ops: on one thread a test worker
    does not oversubscribe the cores that the other workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    pct = _surface(400)
    sources, Rs, ts = _make_pairs(pct, 4, 80)
    return pct, sources, Rs, ts


def _forced_source(pct):
    """tests/test_serving.py::test_fallback_runs_bnb's pair: a ~180 degree
    turn that identity seeding leaves in a wrong basin."""
    rng = np.random.default_rng(7)
    idx = rng.choice(len(pct), size=80, replace=False)
    R = _rot([0, 0, 1], np.pi * 0.95)
    t = np.asarray([0.1, -0.05, 0.04], np.float32)
    return (pct[idx] - t) @ R, R


def _ragged(pct, sizes, seed, angle=None):
    rng = np.random.default_rng(seed)
    clouds, Rs = [], []
    for ns in sizes:
        idx = rng.choice(len(pct), size=ns, replace=False)
        R = _rot(rng.normal(size=3),
                 rng.uniform(0.1, 0.5) if angle is None else angle)
        t = rng.uniform(-0.2, 0.2, size=3).astype(np.float32)
        clouds.append((pct[idx] - t) @ R)
        Rs.append(R)
    return clouds, Rs


# ---------------------------------------------------------------------------
# _seed_pairs
# ---------------------------------------------------------------------------


class _Spy:
    """Records every icp_batched call of a module (its R0 and its outputs)
    while delegating to the real function."""

    def __init__(self, monkeypatch, module):
        self.calls = []
        real = module.icp_batched

        def spy(*args, **kw):
            out = real(*args, **kw)
            self.calls.append((np.asarray(args[2]),
                               [np.asarray(o) for o in out]))
            return out
        monkeypatch.setattr(module, "icp_batched", spy)

    def winners(self, b, s_cnt):
        """Each pair's winning start: the first seeding lane of the pair
        whose pose is the polish's starting pose (equal poses have equal
        SSEs, and argmin keeps the first)."""
        (_, (_, R_l, _)), (R0_polish, _) = self.calls[0], self.calls[1]
        R_l = R_l.reshape(b, s_cnt, 3, 3)
        return [int(np.flatnonzero((R_l[i] == R0_polish[i]).all(
            axis=(1, 2)))[0]) for i in range(b)]


@pytest.fixture(scope="module")
def seed_inputs(problem):
    """Noisy copies of the problem's sources (so the SSEs are not zero), the
    centred target and a 64-point proxy coreset of it (JAX's FPS)."""
    pct, sources, _, _ = problem
    rng = np.random.default_rng(21)
    noisy = (sources + rng.normal(scale=2e-3, size=sources.shape)).astype(
        np.float32)
    pct_c = (pct - pct.mean(axis=0)).astype(np.float32)
    proxy = np.array(jcoreset.build(jnp.asarray(pct_c), size=64,
                                      seed=0).points)
    # A ragged batch (80, 55, 70, 40 real rows; padding repeats row 0 with
    # weight 0) and its per-pair 48-row subsample, drawn as the service does.
    ragged = noisy.copy()
    weights = np.zeros(noisy.shape[:2], np.float32)
    idx2 = []
    sub_rng = np.random.default_rng(7)
    for i, n in enumerate((80, 55, 70, 40)):
        ragged[i, n:] = ragged[i, 0]
        weights[i, :n] = 1.0
        idx2.append(np.tile(sub_rng.permutation(n), -(-48 // n))[:48])
    idx1 = np.random.default_rng(7).permutation(80)[:56]
    return dict(pct_c=pct_c, proxy=proxy, noisy=noisy, ragged=ragged,
                weights=weights, idx1=idx1, idx2=np.stack(idx2))


@pytest.mark.parametrize("case", [
    "whole-sources", "rescore", "subsample-1d", "ragged-2d", "trimmed"])
def test_seed_pairs_matches_jax(seed_inputs, case, monkeypatch):
    d = seed_inputs
    sources, target, w, idx = d["noisy"], d["proxy"], None, None
    trim, rescore = None, True
    if case == "whole-sources":
        target, rescore = d["pct_c"], False
    elif case == "subsample-1d":
        idx = d["idx1"]
    elif case == "ragged-2d":
        sources, w, idx, rescore = d["ragged"], d["weights"], d["idx2"], False
    elif case == "trimmed":
        idx, trim = d["idx1"], 68
    starts = jserving.start_rotations(True)
    conv, conv_final = 0.005, 0.0005

    jspy = _Spy(monkeypatch, jicp)
    # The jitted function's body, run eagerly so that the spy sees the
    # calls (icp_batched and exact_sse_batched stay jitted).
    out_j = jserving._seed_pairs.__wrapped__(
        jnp.asarray(d["pct_c"]), jnp.asarray(target), sources, starts,
        np.float32(conv), np.float32(conv_final),
        seed_idx=None if idx is None else jnp.asarray(idx, jnp.int32),
        trim_keep=trim, max_iter=100, rescore=rescore,
        point_weights=None if w is None else jnp.asarray(w))
    tspy = _Spy(monkeypatch, ticp)
    out_t = tserving._seed_pairs(
        torch.from_numpy(d["pct_c"]), torch.from_numpy(target),
        torch.from_numpy(sources), torch.from_numpy(starts), conv,
        conv_final, seed_idx=None if idx is None else torch.from_numpy(idx),
        trim_keep=trim, max_iter=100, rescore=rescore,
        point_weights=None if w is None else torch.from_numpy(w))
    sse_j, R_j, t_j, scale_j, mu_j = (np.asarray(o) for o in out_j)
    sse_t, R_t, t_t, scale_t, mu_t = (o.numpy() for o in out_t)

    b, s_cnt = len(sources), len(starts)
    assert tspy.winners(b, s_cnt) == jspy.winners(b, s_cnt)
    np.testing.assert_allclose(scale_t, scale_j, rtol=1e-6)
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-6)
    np.testing.assert_allclose(sse_t, sse_j, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(R_t, R_j, atol=1e-4)
    np.testing.assert_allclose(t_t, t_j, atol=1e-4)
    assert np.all(sse_t > 1e-6)  # the noise keeps every SSE above zero


def test_seed_pairs_lanes_are_pair_major(seed_inputs, monkeypatch):
    """Lane b*S + s runs start s on pair b: the seeding call's R0 tiles the
    starts, its sources repeat each pair S times."""
    d = seed_inputs
    starts = jserving.start_rotations(True)
    seen = {}
    real = ticp.icp_batched

    def spy(pct, pcs, R0, t0, **kw):
        seen.setdefault("args", (pcs, R0))
        return real(pct, pcs, R0, t0, **kw)
    monkeypatch.setattr(ticp, "icp_batched", spy)
    sources = torch.from_numpy(d["noisy"])
    tserving._seed_pairs(torch.from_numpy(d["pct_c"]),
                         torch.from_numpy(d["proxy"]), sources,
                         torch.from_numpy(starts), 0.005, 0.0005)
    pcs, R0 = seen["args"]
    s_cnt = len(starts)
    centred = sources - sources.mean(dim=1, keepdim=True)
    for lane in (0, 1, s_cnt - 1, s_cnt, 2 * s_cnt + 3, 4 * s_cnt - 1):
        assert torch.equal(R0[lane], torch.from_numpy(starts[lane % s_cnt]))
        assert torch.equal(pcs[lane], centred[lane // s_cnt])


# ---------------------------------------------------------------------------
# GoICP hand-offs
# ---------------------------------------------------------------------------


def test_goicp_handoffs_match_jax(problem):
    """seed_pose_centered and a shared_proxy taken from JAX's 64-point FPS
    coreset of the centred target (rescaled per pair, covering radius
    included).  The seed pose is wrong, so stage 1 (seed + identity) does
    not certify and stage 2 widens back to the 14 other starts, one of which
    finds this quarter-turn pair: 2 + 16 seeding ICPs and the polish, no
    BnB.  The BnB behind the hand-offs is held to JAX's in
    test_register_matches_jax[forced-fallback]."""
    pct, *_ = problem
    rng = np.random.default_rng(11)
    idx = rng.choice(len(pct), size=80, replace=False)
    R_true = _rot([1, 0, 0], 1.5)
    source = (pct[idx] - np.asarray([0.05, 0.1, -0.03], np.float32)) @ R_true
    pct_c = jnp.asarray(pct - pct.mean(axis=0))
    cs = jcoreset.build(pct_c, size=64, seed=0)
    shared_t, _ = tcoreset.state_from_numpy(
        {"points": np.asarray(cs.points), "eps": np.asarray(cs.eps)}, "cpu")
    seed = (_rot([0, 0, 1], np.pi * 0.95),
            np.asarray([0.05, 0.0, -0.02], np.float32))
    jm = JGoICP(pct, source, mse_threshold=1e-3, engine=std_engine(**MULTI),
                seed_pose_centered=seed, shared_proxy=cs)
    tm = TGoICP(pct, source, mse_threshold=1e-3, engine=_t_engine(**MULTI),
                seed_pose_centered=seed, shared_proxy=shared_t, device="cpu")
    np.testing.assert_allclose(tm.backend.coreset.points.numpy(),
                               np.asarray(jm.backend.coreset.points),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(tm.backend.coreset.eps),
                               float(jm.backend.coreset.eps), rtol=1e-6)
    np.testing.assert_allclose(tm._seed_pose[1], jm._seed_pose[1], rtol=1e-6)
    assert float(jm.backend.coreset.eps) > 0.0
    jm.run()
    tm.run()
    _same_certificate(jm, tm)
    assert tm.stats.icp_runs == 2 + 16 + 1
    assert tm.stats.rotation_children == 0
    np.testing.assert_allclose(tm.best_rotation, R_true, atol=1e-3)


def _same_certificate(jm, tm):
    """The hand-off parity of two finished engines."""
    for m in (jm, tm):
        assert m.last_certified_gap <= m.sse_threshold
    assert abs(jm.best_sse - tm.best_sse) <= tm.sse_threshold
    assert tm.stats.rotation_children == jm.stats.rotation_children
    assert tm.stats.icp_runs == jm.stats.icp_runs


def _record_engines(monkeypatch, module, cls):
    """Replace `module.GoICP` by a subclass that lists its instances."""
    made = []

    class Recorded(cls):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)
    monkeypatch.setattr(module, "GoICP", Recorded)
    return made


# ---------------------------------------------------------------------------
# RegistrationService.register
# ---------------------------------------------------------------------------


def _scenario(problem, name):
    """(service kwargs, engine overrides, sources, register kwargs)."""
    pct, sources, _, _ = problem
    if name == "equal":
        return {}, MULTI, sources, {}
    if name == "ragged":
        return {}, MULTI, _ragged(pct, (80, 55, 103), 5)[0], {}
    if name == "ragged-skewed-subsample":
        # The seeding is the point here (each pair's subsample draws its
        # real rows); its pairs' fallbacks are the forced case's BnB.
        return (dict(seed_subsample=64), MULTI,
                _ragged(pct, (24, 400), 9, angle=0.3)[0],
                dict(fallback=False))
    if name == "trimmed":
        noisy = sources.copy()
        noisy[:, :8] = np.random.default_rng(3).uniform(-2, 2, (4, 8, 3))
        return dict(trim_fraction=0.15), MULTI, noisy, {}
    source, _ = _forced_source(pct)
    if name == "no-fallback":
        return {}, {}, source[None], dict(fallback=False)
    assert name == "forced-fallback"
    return {}, {}, source[None], {}


@pytest.mark.parametrize("name", [
    "equal", "ragged", "ragged-skewed-subsample", "trimmed", "no-fallback",
    "forced-fallback"])
def test_register_matches_jax(problem, name, monkeypatch):
    pct = problem[0]
    srv_kw, eng, sources, reg_kw = _scenario(problem, name)
    # The fallbacks' engines (the JAX module imports GoICP at call time).
    made_j = _record_engines(monkeypatch, jgoicp, JGoICP)
    made_t = _record_engines(monkeypatch, tserving, TGoICP)
    js = jserving.RegistrationService(pct, mse_threshold=1e-3,
                                      engine=std_engine(**eng), **srv_kw)
    ts = tserving.RegistrationService(pct, mse_threshold=1e-3,
                                      engine=_t_engine(**eng), device="cpu",
                                      **srv_kw)
    res_j = js.register(sources, **reg_kw)
    res_t = ts.register(sources, **reg_kw)
    assert len(res_t) == len(res_j)
    for a, b in zip(res_t, res_j):
        assert (a.certified, a.fallback_used) == (b.certified, b.fallback_used)
        np.testing.assert_allclose(a.R, np.asarray(b.R), atol=1e-3)
        np.testing.assert_allclose(a.t, np.asarray(b.t), atol=1e-3)
        assert np.all(np.isfinite(a.R)) and np.isfinite(a.sse)
    for key in ("pairs", "certified_by_seeding", "fallbacks"):
        assert getattr(ts.stats, key) == getattr(js.stats, key), key
    assert len(made_t) == len(made_j) == ts.stats.fallbacks
    for jm, tm in zip(made_j, made_t):
        _same_certificate(jm, tm)
    if name == "forced-fallback":
        assert ts._fallback_proxy is not None and res_t[0].fallback_used
        assert res_t[0].certified and made_t[0].stats.rotation_children > 0
    elif name == "no-fallback":
        assert not res_t[0].certified and ts._fallback_proxy is None
    elif name == "trimmed":
        assert all(r.certified for r in res_t)
    assert ts.stats.seed_seconds > 0.0


# ---------------------------------------------------------------------------
# The port's own rules
# ---------------------------------------------------------------------------


def test_single_2d_source_is_one_pair_and_falls_back(problem):
    """A [ns, 3] ndarray is a batch of one; its fallback registers the whole
    cloud (the JAX module splits it into rows: ROADMAP Queue 3)."""
    pct = problem[0]
    source, R = _forced_source(pct)
    srv = tserving.RegistrationService(pct, mse_threshold=1e-3,
                                       engine=_t_engine(), device="cpu")
    (res,) = srv.register(source)
    assert res.fallback_used and res.certified
    assert np.abs(res.R - R).max() < 5e-2
    assert srv.stats.pairs == 1 and srv.stats.fallbacks == 1


@pytest.mark.parametrize("ragged", [False, True])
def test_generator_of_sources_is_read_once(problem, ragged):
    pct, sources, _, _ = problem
    clouds = _ragged(pct, (80, 55, 103), 5)[0] if ragged else list(sources)
    srv = tserving.RegistrationService(pct, mse_threshold=1e-3,
                                       engine=_t_engine(**MULTI),
                                       device="cpu")
    from_list = srv.register(clouds, fallback=False)
    from_gen = srv.register((c for c in clouds), fallback=False)
    assert len(from_gen) == len(clouds)
    for a, b in zip(from_gen, from_list):
        assert a.certified and a.certified == b.certified
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_array_equal(a.t, b.t)


def test_mesh_names_its_roadmap_item(problem):
    with pytest.raises(NotImplementedError, match="item 16"):
        tserving.RegistrationService(problem[0], mesh=object(), device="cpu")


def test_input_validation(problem):
    pct, sources, _, _ = problem
    srv = tserving.RegistrationService(pct, device="cpu")
    with pytest.raises(ValueError, match=r"\[B, ns, 3\]"):
        srv.register(np.zeros((2, 5, 2), np.float32))
    with pytest.raises(ValueError, match="NaN"):
        bad = sources.copy()
        bad[0, 0, 0] = np.nan
        srv.register(bad)
    with pytest.raises(ValueError, match=r"source 1 must be \[ns, 3\]"):
        srv.register([np.zeros((10, 3), np.float32),
                      np.zeros((12, 2), np.float32)])
    with pytest.raises(ValueError, match="target"):
        tserving.RegistrationService(np.zeros((4, 2), np.float32),
                                     device="cpu")
    with pytest.raises(ValueError, match="NaN"):
        tserving.RegistrationService(np.full((4, 3), np.nan, np.float32),
                                     device="cpu")
    trimmed = tserving.RegistrationService(pct, trim_fraction=0.2,
                                           engine=_t_engine(), device="cpu")
    with pytest.raises(ValueError, match="ragged"):
        trimmed.register([np.zeros((10, 3), np.float32),
                          np.zeros((12, 3), np.float32)])
    assert srv.stats.pairs == 0


def test_service_defaults_and_device(problem):
    pct = problem[0]
    srv = tserving.RegistrationService(pct, device="cpu")
    assert (srv.proxy_size, srv.seed_subsample, srv.fallback_proxy_size) == (
        4096, 2048, 1024)
    assert srv.pct_c.device.type == "cpu"
    assert len(srv._starts) == 15 and not srv._rescore
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tserving.RegistrationService(pct)


def test_serving_import_never_loads_jax():
    code = ("import sys, fgoicp_tpu_torch.models.serving; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'fgoicp_tpu' not in sys.modules, 'fgoicp_tpu imported'")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------------
# CLI --serve (tests/test_cli.py's cases, on the CPU)
# ---------------------------------------------------------------------------


def _serve_config(tmp_path, pct, output=""):
    tgt = tmp_path / "target.ply"
    write_ply(str(tgt), pct)
    cfg = tmp_path / "run.toml"
    cfg.write_text(f'[io]\ntarget = "{tgt}"\nsource = "{tgt}"\n'
                   f'output = "{output}"\n\n[params]\nmse_threshold = 1e-3\n'
                   f'\n[engine]\nrotation_batch = 2\npool_lanes = 256\n'
                   f'pool_capacity = 8192\n')
    return cfg


def test_cli_serve_batch(tmp_path):
    """--serve registers a glob of ragged scans against the config target in
    one service call and writes a [pair.N] section per cloud."""
    rng = np.random.default_rng(7)
    pct = rng.uniform(-1, 1, size=(400, 3)).astype(np.float32)
    Rs = []
    for i in range(3):
        ang = 0.2 + 0.1 * i
        R = np.array([[np.cos(ang), -np.sin(ang), 0],
                      [np.sin(ang), np.cos(ang), 0],
                      [0, 0, 1]], np.float32)
        t = np.array([0.05 * i, -0.04, 0.08], np.float32)
        write_ply(str(tmp_path / f"scan{i}.ply"),
                  (pct[:200 + 20 * i] - t) @ R)
        Rs.append(R)
    out_toml = tmp_path / "serve.toml"
    cfg = _serve_config(tmp_path, pct, out_toml)
    rc = cli_run(["-c", str(cfg), "--serve", str(tmp_path / "scan*.ply"),
                  "--device", "cpu"])
    assert rc == 0  # every pair certified
    result = tomllib.load(open(out_toml, "rb"))
    assert result["serve"]["pairs"] == 3
    assert result["serve"]["certified"] == 3
    for i in range(3):
        pair = result["pair"][str(i)]
        assert pair["certified"] is True
        assert isinstance(pair["fallback"], bool)
        assert pair["source"].endswith(f"scan{i}.ply")
        np.testing.assert_allclose(np.asarray(pair["rotation"]), Rs[i],
                                   atol=2e-2)
        assert len(pair["translation"]) == 3 and pair["mse"] <= 1e-3


def test_cli_serve_empty_glob(tmp_path):
    pct = np.random.default_rng(0).uniform(-1, 1, (50, 3)).astype(np.float32)
    cfg = _serve_config(tmp_path, pct)
    assert cli_run(["-c", str(cfg), "--serve", str(tmp_path / "nope*.ply"),
                    "--device", "cpu"]) == 1
