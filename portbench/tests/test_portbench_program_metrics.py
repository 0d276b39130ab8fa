"""The readers of the program's own request records (`records.py`, the
metrics fps_ms, icp_iter_ms, host_wait_ms and host_reads): on a synthetic
ring, where they find nothing, and in traced tiny runs of the three cells
on the CPU."""

import math
import sys
import time

import pytest

from fgoicp_tpu_torch.utils import trace
from portbench import run, spec
from portbench.tests.tiny import tiny

NEW = ("fps_ms.register", "icp_iter_ms.register", "icp_iter_ms.serve",
       "host_wait_ms.register", "host_wait_ms.serve",
       "host_reads.register", "host_reads.serve")


def _record(i):
    """Request i: construct.fps 10 ms, icp 40 ms over 20 iterations, 0.5 ms
    of host wait in 30 reads, each times (i + 1)."""
    rec = trace.Request(id=i, kind="register")
    k = i + 1
    rec.spans["construct.fps"] = trace.Span(calls=2, total_s=0.010 * k)
    rec.spans["icp"] = trace.Span(calls=3, total_s=0.040 * k)
    rec.counts.update(icp_iterations=20 * k, host_reads=30 * k)
    rec.host_wait_s = 0.0005 * k
    return rec


def _ctx(later_requests=2, later_pairs=8):
    return {"later_requests": later_requests, "later_pairs": later_pairs,
            "profile": {"busy_s": 0.0}}


@pytest.fixture
def ring(monkeypatch):
    """Four records, 0..3; the later two are 2 and 3 (k = 3 and 4)."""
    recs = [_record(i) for i in range(4)]
    monkeypatch.setattr(trace, "requests", lambda: list(recs))
    return recs


def test_readers_on_a_synthetic_ring(ring):
    read = lambda name, **kw: spec.reader(name)(_ctx(**kw))
    assert read("fps_ms.register") == pytest.approx(35.0)   # (30 + 40) / 2
    for name in ("icp_iter_ms.register", "icp_iter_ms.serve"):
        assert read(name) == pytest.approx(2.0)   # 280 ms / 140 iterations
    assert read("host_wait_ms.register") == pytest.approx(1.75)
    assert read("host_wait_ms.serve") == pytest.approx(3.5 / 8)
    assert read("host_reads.register") == pytest.approx(105.0)
    assert read("host_reads.serve") == pytest.approx(210 / 8)
    # The whole ring.
    assert read("host_reads.register", later_requests=4) == pytest.approx(75)


@pytest.mark.parametrize("ctx", [
    _ctx(later_requests=5),                       # the ring is short
    dict(_ctx(), profile=None),                   # an untraced run
    _ctx(later_requests=0, later_pairs=0)],       # no later request
    ids=["short-ring", "untraced", "no-request"])
def test_readers_find_nothing(ring, ctx):
    for name in NEW:
        assert spec.reader(name)(ctx) is None, name


def test_readers_find_nothing_without_the_tracer(ring, monkeypatch):
    """A checkout of the program without the tracer: its import fails."""
    import fgoicp_tpu_torch.utils as utils
    monkeypatch.setitem(sys.modules, "fgoicp_tpu_torch.utils.trace", None)
    monkeypatch.delattr(utils, "trace")
    for name in NEW:
        assert spec.reader(name)(_ctx()) is None, name


def test_spans_absent_or_iterations_zero(ring):
    for rec in ring:
        rec.spans.pop("construct.fps")
        rec.counts["icp_iterations"] = 0
    assert spec.reader("fps_ms.register")(_ctx()) is None
    assert spec.reader("icp_iter_ms.register")(_ctx()) is None


@pytest.mark.parametrize("cell", ["bunny_toml.random_pose",
                                  "skull_serving.full_views",
                                  "skull_serving.single_view"])
def test_traced_tiny_run_reports_the_new_metrics(cell):
    """The tiny cut leaves construction no farthest-point sampling (600
    target points, under the 1,024-point proxy; 150 source points, under
    the automatic clusters' 2,048): 64 source clusters give it one."""
    bench, c, config, mix = tiny(cell)
    if config["entry"] == "register":
        config["engine"] = dict(config["engine"], source_coreset=64)
    result, _, ctx = run.run_cell(bench, c, 2 ** 31 + 11, 0.1, 1, "cpu",
                                  time.perf_counter(), config, mix)
    assert result["correct"], result["checks"]
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    mine = {m["name"] for m in spec.metrics_of(bench, cell, "per_layer")
            if m["name"] in NEW}
    assert mine and mine <= set(metrics)
    for name in mine:
        assert math.isfinite(metrics[name]) and metrics[name] >= 0, name
    reads = [v for k, v in metrics.items() if k.startswith("host_reads.")]
    assert reads and reads[0] > 0
    if "fps_ms.register" in mine:
        assert 0 < metrics["fps_ms.register"] \
            <= metrics["construct_ms.register"]
        mean_ms = 1e3 * sum(ctx["latencies"]) / len(ctx["latencies"])
        assert metrics["host_wait_ms.register"] <= mean_ms
