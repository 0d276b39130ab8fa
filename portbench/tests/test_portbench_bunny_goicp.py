"""The cell bunny_goicp.fixed_poses on the CPU at tiny sizes: the
`pair_set` mix, the readers of the outer search, the pooled step and the
bound kernels' roofline, and the bound of their counted work.

    python -m pytest portbench/tests/test_portbench_bunny_goicp.py -q
"""

import math
import time

import numpy as np
import pytest

from fgoicp_tpu_torch.utils import trace
from portbench import roofline, roofline_bounds, run, spec, traffic
from portbench.tests.tiny import tiny

CELL = "bunny_goicp.fixed_poses"
NEW = ("bnb_ms.register", "pool_step_ms.register",
       "bounds_roofline.register")
# The other CPU tests' coarse search (tests/util.py STD_ENGINE), so that a
# tiny search-only run takes seconds.
COARSE = dict(rotation_batch=2, pool_lanes=64, pool_capacity=2048,
              rotation_min_span=0.1, translation_min_span=0.2)


def _key(req):
    return req.sources[0].tobytes()


def test_pair_set_replays_one_set_in_an_order_the_seed_deals():
    c = spec.cell(spec.benchmark(), CELL)
    config, mix = spec.config(c["config"]), spec.traffic(c["traffic"])
    config["cloud"] = dict(config["cloud"], points=2000)
    config.update(target_points=300, source_points=100)
    works = [traffic.build(config, mix, s) for s in (1, 2 ** 40 + 3, 7)]
    sets = [sorted(_key(r) for r in w.pool) for w in works]
    assert sets[0] == sets[1] == sets[2]
    assert len(set(sets[0])) == len(works[0].pool) == mix["pool"]
    assert {_key(w.warmup) for w in works} == {_key(works[0].warmup)}
    orders = [[_key(r) for r in w.pool] for w in works]
    assert orders[0] != orders[1] and orders[0] != orders[2]
    again = traffic.build(config, mix, 1)
    assert [_key(r) for r in again.pool] == orders[0]
    for w in works:
        for r in w.pool:
            assert r.target.shape == (300, 3)
            R, t = r.truths[0]
            assert np.allclose(R @ R.T, np.eye(3), atol=1e-5)


def _record(i, bound_pairs=0):
    rec = trace.Request(id=i, kind="register")
    k = i + 1
    rec.spans["bnb"] = trace.Span(calls=1, total_s=0.5 * k)
    rec.spans["inner_bnb"] = trace.Span(calls=4, total_s=0.2 * k)
    rec.counts.update(pool_steps=100 * k, bound_pairs=bound_pairs * k,
                      bound_box_tests=1000 * k, bound_bytes=10 ** 6 * k)
    return rec


def _ctx(busy_s=1e-3, later_requests=2, traced=1):
    return {"later_requests": later_requests, "later_pairs": later_requests,
            "profile": {"requests": traced, "busy_s": busy_s,
                        "kernel_s": {"bounds_lanes_kernel": busy_s,
                                     "nn_kernel": 1.0}}}


@pytest.fixture
def ring(monkeypatch):
    """Records 0..3: 0 the warm-up, 1 the traced request (counting 10^7
    pairs), 2 and 3 the later ones."""
    recs = [_record(i, 5 * 10 ** 6) for i in range(4)]
    monkeypatch.setattr(trace, "requests", lambda: list(recs))
    return recs


def test_readers_on_a_synthetic_ring(ring):
    read = lambda name, **kw: spec.reader(name)(_ctx(**kw))
    assert read("bnb_ms.register") == pytest.approx(1750.0)  # (1.5 + 2) / 2
    # 0.6 + 0.8 s over 300 + 400 steps.
    assert read("pool_step_ms.register") == pytest.approx(2.0)
    # Request 1: 10^7 pairs, 2,000 box tests, 2 MB.
    flops = 8 * 10 ** 7 + 17 * 2000
    want = 100.0 * max(flops / roofline.PEAK_F32_FLOPS,
                       2e6 / roofline.PEAK_BYTES) / 1e-3
    assert read("bounds_roofline.register") == pytest.approx(want)


@pytest.mark.parametrize("ctx", [
    _ctx(later_requests=5),                 # the ring is short
    dict(_ctx(), profile=None),             # an untraced run
    _ctx(later_requests=0, traced=0)],      # no request
    ids=["short-ring", "untraced", "no-request"])
def test_readers_find_nothing(ring, ctx):
    for name in NEW:
        assert spec.reader(name)(ctx) is None, name


def test_readers_find_nothing_on_a_program_without_them(ring):
    """The parent program: no "bnb" span, no pool steps, no bound counts."""
    for rec in ring:
        rec.spans.pop("bnb")
        rec.counts.clear()
    for name in NEW:
        assert spec.reader(name)(_ctx()) is None, name


def test_roofline_stays_below_100_as_pruning_grows(ring):
    """The kernel time of a traced request that took its counted work's
    bound exactly reads 100 %; with fewer pairs counted (more pruning) and
    the time that work takes, it still reads 100 %, and below 100 % with
    any more time."""
    rec = ring[1]
    for scale in (1.0, 0.2, 0.01, 0.0001):
        rec.counts["bound_pairs"] = int(2e7 * scale)
        need = roofline_bounds.bound_s(rec.counts["bound_pairs"],
                                       rec.counts["bound_box_tests"],
                                       rec.counts["bound_bytes"])
        at_bound = spec.reader("bounds_roofline.register")(
            _ctx(busy_s=need))
        assert at_bound == pytest.approx(100.0)
        slower = spec.reader("bounds_roofline.register")(
            _ctx(busy_s=need * 1.5))
        assert 0.0 < slower < 100.0


def _tiny_runs(device):
    """(untraced, traced) (result, ctx) of the tiny cell, with the coarse
    search."""
    bench, c, config, mix = tiny(CELL)
    config["engine"] = dict(config["engine"], **COARSE)
    out = []
    for traced in (0, 1):
        result, _, ctx = run.run_cell(bench, c, 2 ** 31 + 11, 0.1, traced,
                                      device, time.perf_counter(), config,
                                      mix)
        assert result["correct"], result["checks"]
        assert result["failed"] == 0 and result["attempted"] > 0
        out.append((result, ctx))
    return out


@pytest.fixture(scope="module")
def tiny_runs():
    return _tiny_runs("cpu")


def test_new_readers_on_tiny_runs(tiny_runs):
    """None in the untraced run; the outer search and the pooled step
    finite in the traced one, which searched.  The CPU has no device
    trace, so the bound kernels' roofline finds nothing there (the card
    test reads it)."""
    (_, plain), (result, _) = tiny_runs
    for name in NEW:
        assert spec.reader(name)(plain) is None, name
    traced = {k: v["value"] for k, v in result["metrics"].items()}
    assert traced["inner_bnb_ms.register"] > 0
    for name in ("bnb_ms.register", "pool_step_ms.register"):
        assert math.isfinite(traced[name]) and traced[name] > 0, name
    assert "bounds_roofline.register" not in traced


@pytest.mark.card
def test_new_readers_on_tiny_runs_on_the_card(card):
    (_, plain), (result, _) = _tiny_runs(card)
    for name in NEW:
        assert spec.reader(name)(plain) is None, name
    traced = {k: v["value"] for k, v in result["metrics"].items()}
    for name in NEW:
        assert math.isfinite(traced[name]) and traced[name] > 0, name
    assert traced["bounds_roofline.register"] <= 100.0
