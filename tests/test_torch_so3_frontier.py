"""Port parity: the device SO(3) frontier (ops/so3_frontier.py) against the
JAX package's, on `tests/test_config_matrix.py::_problem`.

Pure functions (initial_state, state_from_arrays, merge_states,
certified_gap) must agree exactly.  `so3_bnb_device` runs from one shared
initial state (the JAX engine's initial ICP incumbent) with max_outer 1, 2
and to the end: every counter and hist_len equal, best_sse and the live
frontier lbs at rtol 1e-4 / atol 1e-5, best_R and best_t at atol 1e-4, and
the same certificate verdict.  The engine is `std_engine(outer_mode=
"device", so3_capacity=2048, icp_width=1)`: with one ICP lane a step the
search takes four outer steps.  The JAX states come from one chained run
(1 step, then resumed to 2, then to the end), computed once per module.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from fgoicp_tpu.models.goicp import GoICP as JGoICP
from fgoicp_tpu.ops import so3_frontier as jso3
from fgoicp_tpu_torch import EngineConfig as TEngine
from fgoicp_tpu_torch.models.goicp import GoICP as TGoICP
from fgoicp_tpu_torch.ops import so3_frontier as tso3
from test_config_matrix import _problem
from test_so3_frontier import _state as _jax_state
from util import std_engine

COUNTERS = ("outer_steps", "nodes_expanded", "children_evaluated",
            "inner_nodes", "icp_runs", "icp_triggered", "pruned", "hist_len")
DEVICE = dict(outer_mode="device", so3_capacity=2048, icp_width=1)
END = 10000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path runs many tiny ops: on one thread a test worker
    does not oversubscribe the cores that the other workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_state(s):
    return tso3.SO3State(*(np.asarray(f) for f in s))


def _assert_same_state(got, want):
    """Exact equality of every field, dtype and shape included."""
    for f in tso3.SO3State._fields:
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("cells", [None, [(0.5, 0.5, 0.5, 0.5),
                                          (-0.25, 0.0, 0.25, 0.25)]])
def test_initial_state_matches_jax(cells):
    R = np.asarray([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    t = np.asarray([0.1, -0.2, 0.3], np.float32)
    kw = dict(best_sse=2.5, best_R=R, best_t=t, cells=cells)
    _assert_same_state(tso3.initial_state(16, history_capacity=4, **kw),
                       _np_state(jso3.initial_state(16, history_capacity=4,
                                                    **kw)))
    _assert_same_state(tso3.initial_state(8),
                       _np_state(jso3.initial_state(8)))


def test_state_from_arrays_fills_older_fields_like_jax():
    full = jso3.initial_state(8, history_capacity=4, best_sse=1.5)
    old = {f: np.asarray(getattr(full, f)) for f in full._fields
           if f not in ("ts", "closed_lb")}
    _assert_same_state(tso3.state_from_arrays(old),
                       _np_state(jso3.state_from_arrays(old)))


def _ringed(mod, cap, best_sse, cells, steps, seed):
    """A state with counters and a two-entry improvement ring."""
    rng = np.random.default_rng(seed)
    s = mod.initial_state(cap, history_capacity=4, best_sse=best_sse,
                          best_R=np.eye(3), best_t=rng.normal(size=3),
                          cells=cells)
    lbs = np.asarray(s.lbs).copy()
    lbs[:len(cells)] = np.sort(rng.uniform(0.0, 1.0, len(cells)))
    hist = np.asarray(s.hist_sse).copy()
    hist[:2] = (best_sse + 1.0, best_sse)
    return s._replace(lbs=lbs.astype(np.float32),
                      hist_sse=hist.astype(np.float32),
                      hist_len=np.int32(2), outer_steps=np.int32(steps),
                      inner_nodes=np.int32(100 * steps),
                      dropped_lb=np.float32(0.9 + seed))


@pytest.mark.parametrize("cap", [8, 2], ids=["union", "spill"])
def test_merge_states_matches_jax(cap):
    """Union of the frontiers, the spill past capacity folded into
    dropped_lb, summed counters and the incumbent owner's ring."""
    cells_a = [(0.5, 0.5, 0.5, 0.5), (-0.5, 0.5, 0.5, 0.5)]
    cells_b = [(-0.5, -0.5, -0.5, 0.5), (0.5, -0.5, 0.5, 0.5)]
    states = {}
    for name, mod in (("jax", jso3), ("torch", tso3)):
        states[name] = mod.merge_states([
            _ringed(mod, cap, 2.0, cells_a, 3, 0),
            _ringed(mod, cap, 1.0, cells_b, 4, 1)])
    got, want = states["torch"], _np_state(states["jax"])
    _assert_same_state(got, want)
    assert int(got.outer_steps) == 7 and float(got.best_sse) == 1.0
    assert int(np.sum(got.lbs < tso3.INVALID)) == min(cap, 4)
    if cap == 2:
        assert float(got.dropped_lb) <= 0.9  # a spilled frontier lb


# The cases of tests/test_so3_frontier.py: (frontier lb, dropped lb,
# best_sse, closed lb).
GAP_CASES = {
    "exhausted": (jso3.INVALID, jso3.INVALID, 0.5, jso3.INVALID),
    "exhausted-dropped": (jso3.INVALID, 0.2, 1.0, jso3.INVALID),
    "frontier": (0.3, jso3.INVALID, 1.0, jso3.INVALID),
    "frontier-and-dropped": (0.3, 0.1, 1.0, jso3.INVALID),
    "closed-leaf": (jso3.INVALID, jso3.INVALID, 1.0, 0.05),
    "closed-leaf-within-slack": (jso3.INVALID, jso3.INVALID, 0.1, 0.05),
}


@pytest.mark.parametrize("case", list(GAP_CASES), ids=list(GAP_CASES))
def test_certified_gap_matches_jax(case):
    lb0, dropped, best, closed = (float(v) for v in GAP_CASES[case])
    js = _jax_state(lb0, dropped, best_sse=best, closed_lb=closed)
    want = float(jso3.certified_gap(js))
    assert tso3.certified_gap(_np_state(js)) == want
    # Tensors (the device loop's own state) give the same value.
    ts = tso3.SO3State(*(torch.tensor(np.asarray(f)) for f in js))
    assert tso3.certified_gap(ts) == want


def test_to_device_and_back_keeps_every_field():
    s = _ringed(tso3, 8, 1.0, [(0.5, 0.5, 0.5, 0.5)], 5, 0)
    dev = tso3.to_device(s, "cpu")
    assert dev.outer_steps.dtype == torch.int32
    assert dev.lbs.dtype == torch.float32 and dev.best_sse.shape == ()
    _assert_same_state(tso3.to_host(dev), _np_state(s))


@pytest.fixture(scope="module")
def searches():
    """Both packages' device searches from the JAX engine's initial ICP
    incumbent: JAX chained through max_outer 1 and 2 to the end, the port
    from the initial state each time."""
    pct, pcs, _, _ = _problem()
    eng = std_engine(**DEVICE)
    jm = JGoICP(pct, pcs, mse_threshold=5e-4, engine=eng, proxy_size=64)
    jm._initial_icp()
    init = jso3.initial_state(eng.so3_capacity, best_sse=jm.best_sse,
                              best_R=jm.best_rotation,
                              best_t=jm.best_translation)
    call = jm._device_call_fn()
    jax_states, st = {}, init
    for cap in (1, 2, END):
        st = jax.device_get(call(st, cap))
        jax_states[cap] = st
    tm = TGoICP(pct, pcs, mse_threshold=5e-4, proxy_size=64, device="cpu",
                engine=TEngine(**dataclasses.asdict(eng)))
    tcall = tm._device_call_fn()
    torch_states = {cap: tso3.to_host(tcall(_np_state(init), cap))
                    for cap in (1, 2, END)}
    return jax_states, torch_states, jm.sse_threshold


@pytest.mark.parametrize("max_outer", [1, 2, END], ids=["1", "2", "end"])
def test_device_search_matches_jax(searches, max_outer):
    jax_states, torch_states, thr = searches
    js, ts = jax_states[max_outer], torch_states[max_outer]
    for f in COUNTERS:
        assert int(getattr(ts, f)) == int(getattr(js, f)), f
    np.testing.assert_allclose(float(ts.best_sse), float(js.best_sse),
                               rtol=1e-4, atol=1e-5)
    live = np.asarray(js.lbs) < jso3.INVALID
    np.testing.assert_array_equal(ts.lbs < tso3.INVALID, live)
    np.testing.assert_allclose(ts.lbs[live], np.asarray(js.lbs)[live],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ts.best_R, js.best_R, atol=1e-4)
    np.testing.assert_allclose(ts.best_t, js.best_t, atol=1e-4)
    assert (tso3.certified_gap(ts) <= thr) == \
        (float(jso3.certified_gap(js)) <= thr)
    if max_outer == END:
        assert int(ts.outer_steps) > 2
        assert tso3.certified_gap(ts) <= thr


def test_sharding_arguments_name_their_roadmap_item():
    pct, pcs, _, _ = _problem()
    tm = TGoICP(pct, pcs, mse_threshold=5e-4, proxy_size=64, device="cpu",
                engine=TEngine(**dataclasses.asdict(std_engine(**DEVICE))))
    for kw in (dict(points_axis="points"), dict(cubes_axis="cubes",
                                                n_cubes=2)):
        with pytest.raises(NotImplementedError, match="item 6"):
            tso3.so3_bnb_device(tm.backend, tm.pct, tm.pcs, tm.pcs, 1.0,
                                np.eye(3), np.zeros(3), 0.05, **kw)
