"""Port parity: checkpoint/resume (fgoicp_tpu_torch/utils/checkpoint.py and
GoICP.save_checkpoint / load_checkpoint / load_checkpoints) against the JAX
package, on `tests/test_checkpoint.py::_pair` and
`tests/test_config_matrix.py::_problem`.

Both packages write one container, so checkpoints cross between them in both
directions for both kinds (host heap, device SO3State) and the cloud
fingerprints are byte-equal.  A run resumed from a checkpoint must reach the
JAX package's resumed best_sse (rtol 1e-4, atol 1e-9: the exact-subset pairs'
optimum is ~1e-12, float32 noise) and, in device mode, the same counters.
The device engine is `std_engine(outer_mode="device", so3_capacity=2048,
icp_width=1)`, a four-step search on `_problem`, interrupted after its
second one-step chunk.
"""
import dataclasses

import numpy as np
import pytest
import torch

from fgoicp_tpu.models.goicp import GoICP as JGoICP
from fgoicp_tpu.utils import checkpoint as jckpt
from fgoicp_tpu_torch import EngineConfig as TEngine
from fgoicp_tpu_torch.models.goicp import GoICP as TGoICP
from fgoicp_tpu_torch.ops import so3_frontier as tso3
from fgoicp_tpu_torch.utils import checkpoint as tckpt
from test_checkpoint import _pair
from test_config_matrix import _problem
from util import std_engine

DEVICE = dict(outer_mode="device", so3_capacity=2048, icp_width=1)
MSE = 5e-4


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


def _model(pkg, kind, **engine):
    """A GoICP of either package on the kind's pair."""
    pct, pcs = _pair() if kind == "host" else _problem()[:2]
    if kind == "device":
        engine = dict(DEVICE, **engine)
    if pkg == "jax":
        return JGoICP(pct, pcs, mse_threshold=MSE, proxy_size=64,
                      engine=std_engine(**engine))
    return TGoICP(pct, pcs, mse_threshold=MSE, proxy_size=64, device="cpu",
                  engine=_t_engine(**engine))


def _interrupted(pkg, kind, path, saves=2):
    """Run with a checkpoint after every outer step (device: every chunk of
    one step) and die right after the `saves`-th checkpoint lands."""
    m = _model(pkg, kind, checkpoint_path=path, checkpoint_every=1)
    name = "save_checkpoint" if kind == "host" else "_save_device_checkpoint"
    real, calls = getattr(m, name), []

    def dying_save(*args):
        real(*args)
        calls.append(1)
        if len(calls) == saves:
            raise RuntimeError("simulated kill")

    setattr(m, name, dying_save)
    with pytest.raises(RuntimeError, match="simulated kill"):
        m.run()
    assert tckpt.peek_kind(path) == ("host_heap" if kind == "host"
                                     else "device_state")


def _resumed(pkg, kind, path, **engine):
    m = _model(pkg, kind, **engine)
    m.load_checkpoint(path)
    m.run()
    return m


def test_low_level_files_cross_packages(tmp_path):
    heap = [(0.5, 0, (0.1, 0.2, 0.3, 0.25, 1.5, 0.01, -0.02, 0.03)),
            (1.5, 1, (-0.1, -0.2, -0.3, 0.5, 9.9, 0.0, 0.0, 0.0))]
    kw = dict(heap=heap, tie=7, best_sse=1.25, best_rotation=np.eye(3),
              best_translation=np.arange(3.0), stats={"outer_steps": 3},
              fingerprint="abc", closed_leaf_lb=0.75)
    state = {f: np.asarray(v) for f, v in
             tso3.initial_state(8, history_capacity=4)._asdict().items()}
    for save, load in ((tckpt, jckpt), (jckpt, tckpt)):
        path = str(tmp_path / "host.npz")
        save.save(path, **kw)
        st = load.load(path, fingerprint="abc")
        assert st["heap"] == heap and st["tie"] == 7
        assert st["best_sse"] == 1.25 and st["closed_leaf_lb"] == 0.75
        assert st["stats"] == {"outer_steps": 3}
        np.testing.assert_array_equal(st["best_translation"], np.arange(3.0))
        assert st["best_rotation"].dtype == np.float32
        path = str(tmp_path / "dev.npz")
        save.save_device_state(path, state_arrays=state,
                               stats={"outer_steps": 3}, fingerprint="abc")
        got = load.load_device_state(path, fingerprint="abc")
        assert got["stats"] == {"outer_steps": 3}
        for f, a in state.items():
            b = got["state_arrays"][f]
            assert b.dtype == a.dtype
            np.testing.assert_array_equal(b, a)
        assert load.peek_kind(path) == "device_state"
        with pytest.raises(ValueError, match="fingerprint"):
            load.load_device_state(path, fingerprint="other")


def test_cloud_fingerprint_is_byte_equal():
    pct, pcs = _pair()
    for a, b in ((pct, pcs), (pct.astype(np.float64), pcs[:50])):
        assert tckpt.cloud_fingerprint(a, b) == jckpt.cloud_fingerprint(a, b)
    # GoICP hashes the float32 clouds as given, before normalization.
    m = TGoICP(pct.astype(np.float64), pcs, mse_threshold=MSE, device="cpu",
               engine=_t_engine())
    assert m._fingerprint == jckpt.cloud_fingerprint(pct, pcs)


def test_host_resume_matches_fresh(tmp_path):
    path = str(tmp_path / "bnb.npz")
    m_full = _model("torch", "host", checkpoint_path=path,
                    checkpoint_every=1)
    m_full.run()
    m_res = _resumed("torch", "host", path)
    assert m_res.best_sse <= m_full.best_sse * 1.0001 + 1e-9
    # The resume skipped the initial ICP (the stats came with the state).
    assert m_res.stats.icp_runs >= m_full.stats.icp_runs - 1
    assert m_res.last_certified_gap <= m_res.sse_threshold


def test_device_chunked_resume_after_kill(tmp_path):
    """The device search in one-step chunks, killed after the second chunk's
    checkpoint and resumed with the sanitizer on, ends as the one-call run:
    the same counters and optimum."""
    m_full = _model("torch", "device")
    m_full.run()
    path = str(tmp_path / "dev.npz")
    _interrupted("torch", "device", path)
    m_res = _model("torch", "device", checkpoint_path=path,
                   checkpoint_every=1, debug_checks=True)
    m_res.load_checkpoint(path)
    assert m_res.stats.outer_steps == 2
    m_res.run()
    assert m_full.stats.outer_steps > 2
    for f in ("outer_steps", "rotation_nodes", "rotation_children",
              "translation_nodes", "rotation_pruned"):
        assert getattr(m_res.stats, f) == getattr(m_full.stats, f), f
    np.testing.assert_allclose(m_res.best_sse, m_full.best_sse, rtol=1e-4,
                               atol=1e-9)
    assert m_res.mse < MSE
    assert m_res.last_certified_gap <= m_res.sse_threshold


def test_checkpoint_kind_mismatch_names_the_outer_mode(tmp_path):
    mh = _model("torch", "host")
    hpath = str(tmp_path / "host.npz")
    mh.save_checkpoint(hpath)
    md = _model("torch", "host", outer_mode="device")
    with pytest.raises(ValueError, match="outer_mode='host'"):
        md.load_checkpoint(hpath)
    dpath = str(tmp_path / "dev.npz")
    tckpt.save_device_state(
        dpath, state_arrays={"best_sse": np.float32(1.0)}, stats={},
        fingerprint=mh._fingerprint)
    with pytest.raises(ValueError, match="outer_mode='device'"):
        mh.load_checkpoint(dpath)


def test_checkpoint_rejects_wrong_clouds(tmp_path):
    pct, pcs = _pair()
    path = str(tmp_path / "bnb.npz")
    TGoICP(pct, pcs, mse_threshold=MSE, device="cpu",
           engine=_t_engine()).save_checkpoint(path)
    other = TGoICP(pct[:-1], pcs, mse_threshold=MSE, device="cpu",
                   engine=_t_engine())
    with pytest.raises(ValueError, match="fingerprint"):
        other.load_checkpoint(path)


def _two_checkpoints(tmp_path, kind):
    """Two checkpoints of one pair, as two processes of a partitioned run
    would leave them: disjoint frontiers, different incumbents and
    counters."""
    m = _model("torch", kind)
    fp = m._fingerprint
    stats = [dict(dataclasses.asdict(m.stats), outer_steps=s,
                  translation_nodes=100 * s, wall_seconds=float(s))
             for s in (3, 4)]
    paths = [str(tmp_path / f"{kind}{i}.npz") for i in range(2)]
    # The root cube's eight octants, four in each frontier.
    octants = [(x, y, z, 0.5) for x in (-0.5, 0.5) for y in (-0.5, 0.5)
               for z in (-0.5, 0.5)]
    cells = (octants[::2], octants[1::2])
    for i, (path, cs) in enumerate(zip(paths, cells)):
        best = (2.0, 1.0)[i]
        R = np.eye(3) if i == 0 else np.diag([1.0, -1.0, -1.0])
        t = np.full(3, 0.1 * i)
        if kind == "host":
            heap = [(0.25 * (j + 1) + i, j, c + (5.0, 0.0, 0.0, 0.0))
                    for j, c in enumerate(cs)]
            tckpt.save(path, heap=heap, tie=len(heap), best_sse=best,
                       best_rotation=R, best_translation=t, stats=stats[i],
                       fingerprint=fp, closed_leaf_lb=0.5 + i)
        else:
            s = tso3.initial_state(DEVICE["so3_capacity"], best_sse=best,
                                   best_R=R, best_t=t, cells=cs)
            s = s._replace(outer_steps=np.int32(3 + i),
                           inner_nodes=np.int32(100 * (3 + i)),
                           dropped_lb=np.float32(0.4 + i))
            tckpt.save_device_state(path, state_arrays=s._asdict(),
                                    stats=stats[i], fingerprint=fp)
    return paths


@pytest.mark.parametrize("kind", ["host", "device"])
def test_load_checkpoints_merges_like_jax(tmp_path, kind):
    paths = _two_checkpoints(tmp_path, kind)
    jm, tm = _model("jax", kind), _model("torch", kind)
    for m in (jm, tm):
        m.load_checkpoints(paths)
    assert tm.stats == type(tm.stats)(**dataclasses.asdict(jm.stats))
    assert tm.stats.outer_steps == 7 and tm.stats.wall_seconds == 4.0
    assert tm.best_sse == jm.best_sse == 1.0
    np.testing.assert_array_equal(tm.best_rotation, jm.best_rotation)
    np.testing.assert_array_equal(tm.best_translation, jm.best_translation)
    if kind == "host":
        assert tm._resumed_heap == jm._resumed_heap
        assert tm._closed_leaf_lb == jm._closed_leaf_lb == 0.5
        assert next(tm._tie) == next(jm._tie)
    else:
        for f in tso3.SO3State._fields:
            a = np.asarray(getattr(tm._resumed_so3_state, f))
            b = np.asarray(getattr(jm._resumed_so3_state, f))
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    # The merged state resumes to a certified optimum in the port.
    tm.run()
    assert tm.last_certified_gap <= tm.sse_threshold
    assert tm.mse < MSE


@pytest.mark.parametrize("kind", ["host", "device"])
def test_checkpoints_resume_across_packages(tmp_path, kind):
    """A checkpoint JAX writes resumes in the port to JAX's own resumed
    optimum (device: with JAX's counters), and a checkpoint the port
    writes resumes in JAX to the port's."""
    saves = 1 if kind == "host" else 2
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    _interrupted("jax", kind, jpath, saves)
    _interrupted("torch", kind, tpath, saves)
    for path in (jpath, tpath):
        jm = _resumed("jax", kind, path)
        tm = _resumed("torch", kind, path)
        np.testing.assert_allclose(tm.best_sse, jm.best_sse, rtol=1e-4,
                                   atol=1e-9)
        assert tm.last_certified_gap <= tm.sse_threshold
        assert jm.last_certified_gap <= jm.sse_threshold
        if kind == "device":
            for f in ("outer_steps", "rotation_nodes", "rotation_children",
                      "translation_nodes", "rotation_pruned"):
                assert getattr(tm.stats, f) == getattr(jm.stats, f), f


@pytest.mark.parametrize("improved", [False, True],
                         ids=["unchanged", "improved"])
def test_device_adopt_reads_a_saturated_ring_like_jax(improved):
    """A state resumed with its ring full (hist_len at capacity) keeps
    writing improvements into the last slot: that slot counts as unseen, so
    an improvement after the resume reaches model.history and an unchanged
    slot does not."""
    hist = np.asarray([4.0, 3.0, 2.0, 1.0], np.float32)
    if improved:
        hist[-1] = 0.5
    st = tso3.initial_state(8, history_capacity=4)._replace(
        hist_sse=hist, hist_len=np.int32(4), best_sse=np.float32(hist[-1]))
    histories = {}
    for pkg in ("jax", "torch"):
        m = _model(pkg, "device")
        m.history = [(0.0, 1.0, np.eye(3, dtype=np.float32),
                      np.zeros(3, np.float32))]
        m.best_sse = 1.0
        m._device_adopt(st, hist_seen=4)
        histories[pkg] = [h[1] for h in m.history]
        assert m.best_sse == float(hist[-1])
    assert histories["torch"] == histories["jax"]
    assert histories["torch"] == ([1.0, 0.5] if improved else [1.0])
