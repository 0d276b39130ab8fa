"""The port's tracer (fgoicp_tpu_torch/utils/trace.py) on the CPU: one
request record per public entry, spans that nest, the counts and host
reads at their boundaries, the launch and mesh counter deltas, results
bit-equal with the profiler ranges on and off, and the ranges in a
torch.profiler trace only while they are on.

Problems: `tests/test_serving.py`'s `_surface(400)` with 80-point sources,
`std_engine`, and a source engine of 32 clusters so that construction runs
farthest-point sampling.  A source turned 1.6 rad, which identity seeding
leaves in a wrong basin, makes `register` search and takes the serving
fallback; the service's batch adds a pair that seeding certifies.  Each
entry runs twice, with the ranges off and with them on under the profiler.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fgoicp_tpu_torch import Config, EngineConfig
from fgoicp_tpu_torch.models import icp as ticp
from fgoicp_tpu_torch.models.goicp import GoICP, register
from fgoicp_tpu_torch.models.serving import RegistrationService
from fgoicp_tpu_torch.ops import coreset, cuda_bounds, cuda_icp, cuda_minplus
from fgoicp_tpu_torch.ops import cuda_fps, cuda_nn, cuda_pool
from fgoicp_tpu_torch.ops import procrustes
from fgoicp_tpu_torch.utils import trace
from test_serving import _make_pairs, _rot, _surface
from util import std_engine
from torch_threads import one_torch_thread  # noqa: F401

CLUSTERS = 32


def _engine(**overrides):
    return EngineConfig(**dataclasses.asdict(
        std_engine(source_coreset=CLUSTERS, **overrides)))


@pytest.fixture(scope="module")
def problem():
    pct = _surface(400)
    sources, _, _ = _make_pairs(pct, 1, 80)
    idx = np.random.default_rng(3).choice(len(pct), size=80, replace=False)
    turned = (pct[idx] - 0.05) @ _rot([0, 1, 1], 1.6)
    return pct, turned, np.stack([turned, sources[0]])


def _new_records(fn):
    """(fn's result, the records it added)."""
    last = trace.requests()[-1].id if trace.requests() else 0
    out = fn()
    return out, [r for r in trace.requests() if r.id > last]


class _Spy:
    """Records each call of module.name's original, then calls it."""

    def __init__(self, monkeypatch, module, name, take):
        self.calls = []
        original = getattr(module, name)

        def spy(*args, **kw):
            self.calls.append(take(*args, **kw))
            return original(*args, **kw)

        monkeypatch.setattr(module, name, spy)


def _run_register(problem):
    pct, pcs, _ = problem
    cfg = Config()
    cfg.engine = _engine()
    model, R, t = register(cfg, pct, pcs, device="cpu")
    return model, R, t


def _run_serve(problem):
    srv = RegistrationService(problem[0], mse_threshold=1e-3,
                              engine=_engine(), fallback_proxy_size=64,
                              device="cpu")
    return srv, srv.register(problem[2])


def _traced(monkeypatch, run, problem):
    """run(problem) with spies on FPS (its k), the ICP's Procrustes (one
    call an iteration) and the host reads (tensors a call); returns (out,
    record, spies)."""
    spies = dict(
        fps=_Spy(monkeypatch, coreset, "farthest_point_sample",
                 lambda points, k, seed=0: k),
        reads=_Spy(monkeypatch, trace, "to_host",
                   lambda *tensors: len(tensors)),
        procrustes=_Spy(monkeypatch, procrustes, "procrustes",
                        lambda *a, **kw: 1))
    before = trace.launch_counts()
    out, recs = _new_records(lambda: run(problem))
    assert len(recs) == 1
    after = trace.launch_counts()
    return out, recs[0], spies, {k: after[k] - before[k] for k in after}


def _profiled(fn):
    """(fn(), the names of the program's ranges in its profile)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    return out, [n for n in names if n.startswith(trace.PREFIX)]


@pytest.fixture(scope="module")
def runs(problem):
    """Both entries, with the ranges off: {kind: (out, record, spies,
    launch deltas)}."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for kind, run in (("register", _run_register),
                          ("serve", _run_serve)):
            out[kind] = _traced(mp, run, problem)
            mp.undo()
    finally:
        mp.undo()
    return out


@pytest.fixture(scope="module")
def ranged(problem):
    """Both entries again, with the ranges on, under the profiler: {kind:
    (out, record, range names)}."""
    out = {}
    trace.enable()
    try:
        for kind, run in (("register", _run_register),
                          ("serve", _run_serve)):
            (res, recs), ranges = _profiled(lambda: _new_records(
                lambda: run(problem)))
            out[kind] = (res, recs[0], ranges)
    finally:
        trace.enable(False)
    return out


def test_register_opens_one_record(runs):
    (model, _, _), rec, _, _ = runs["register"]
    assert rec.kind == "register"
    assert {"register", "construct", "construct.fps", "icp",
            "inner_bnb"} <= set(rec.spans)
    assert rec.spans["construct.fps"].under == {
        "construct": pytest.approx(rec.spans["construct.fps"].total_s)}
    assert model.stats.wall_seconds <= rec.seconds


def test_service_fallback_joins_its_request(runs):
    (srv, results), rec, _, _ = runs["serve"]
    assert rec.kind == "serve"
    assert [r.fallback_used for r in results] == [True, False]
    assert srv.stats.fallbacks == 1
    assert set(rec.spans["seed"].under) == {"serve"}
    assert set(rec.spans["fallback"].under) == {"serve"}
    # The fallback's GoICP: its construction and its run's ICPs (the
    # search's refine ICPs inside its outer search).
    assert set(rec.spans["construct"].under) == {"fallback"}
    assert set(rec.spans["icp"].under) == {"seed", "fallback", "bnb"}
    assert rec.spans["fallback"].calls == 1
    assert srv.stats.fallback_seconds >= rec.spans["fallback"].total_s
    assert srv.stats.seed_seconds >= rec.spans["seed"].total_s


@pytest.mark.parametrize("kind", ["register", "serve"])
def test_spans_nest(runs, kind):
    rec = runs[kind][1]
    assert rec.spans[kind].calls == 1
    assert rec.spans[kind].total_s == pytest.approx(rec.seconds)
    children = {}
    for name, span in rec.spans.items():
        assert 0.0 <= span.self_s <= span.total_s
        assert span.host_wait_s <= span.self_s
        for parent, s in span.under.items():
            children[parent] = children.get(parent, 0.0) + s
    for parent, s in children.items():
        assert rec.spans[parent].total_s >= s
        assert rec.spans[parent].self_s == pytest.approx(
            rec.spans[parent].total_s - s, abs=1e-6)
    assert set(rec.spans[kind].under) == set()
    assert sum(s.host_reads for s in rec.spans.values()) == rec.host_reads
    assert sum(s.host_wait_s for s in rec.spans.values()) == pytest.approx(
        rec.host_wait_s)


@pytest.mark.parametrize("kind", ["register", "serve"])
def test_counts(runs, kind):
    out, rec, spies, launches = runs[kind]
    ks = spies["fps"].calls
    assert ks and rec.counts["fps_steps"] == sum(k - 1 for k in ks)
    assert rec.counts["icp_iterations"] == len(spies["procrustes"].calls)
    assert rec.host_reads == sum(spies["reads"].calls) > 0
    assert rec.spans["icp"].calls > 0 and rec.counts["icp_lanes"] > 0
    model = out[0]
    if kind == "register":
        assert rec.counts["inner_nodes"] == model.stats.translation_nodes > 0
    assert rec.launches == launches


def test_run_on_its_own_opens_a_record_without_construction(problem):
    """GoICP.run called on its own (here the device outer loop, whose
    counters reach GoICPStats chunk by chunk) is a request; the model's
    construction before it is in none."""
    pct, pcs, _ = problem
    (model, recs) = _new_records(lambda: GoICP(
        pct, pcs, engine=_engine(outer_mode="device", so3_capacity=4096),
        device="cpu"))
    assert recs == []
    _, recs = _new_records(model.run)
    (rec,) = recs
    assert rec.kind == "register" and "construct" not in rec.spans
    assert rec.counts["inner_nodes"] == model.stats.translation_nodes > 0
    assert rec.counts["fps_steps"] == 0 and rec.host_reads > 0


def test_icp_iterations_and_reads_by_hand():
    """A two-lane ICP inside a request: its iterations (one Procrustes
    each) and one read of the loop condition an iteration, plus the read
    that ends the loop on convergence."""
    pct = torch.as_tensor(_surface(300))
    pcs = pct[::3].clone()
    R0 = torch.as_tensor(np.stack([_rot([0, 0, 1], 0.2),
                                   _rot([1, 0, 0], 0.1)]))
    t0 = torch.tensor([[0.05, 0.0, 0.0], [0.0, -0.03, 0.02]])
    steps = []
    real = procrustes.procrustes

    def counted(*a, **kw):
        steps.append(1)
        return real(*a, **kw)

    procrustes.procrustes = counted
    try:
        _, recs = _new_records(trace.entry("register")(
            lambda: ticp.icp_batched(pct, pcs, R0, t0, max_iter=100,
                                     convergence_threshold=1e-3)))
    finally:
        procrustes.procrustes = real
    (rec,) = recs
    assert 0 < len(steps) < 100
    assert rec.counts["icp_iterations"] == len(steps)
    assert rec.counts["icp_lanes"] == 2
    assert rec.host_reads == len(steps) + 1
    assert rec.spans["icp"].host_reads == rec.host_reads


def test_launch_and_mesh_deltas_read_the_existing_counters():
    """The record reads the wrappers' `launches` and a watched mesh's
    counters; it keeps no count of its own."""
    class Mesh:
        def __init__(self):
            self.c = dict(collectives=3, bytes=100, host_copies=1)

        def counters(self):
            return dict(self.c)

    mesh = Mesh()
    wrappers = (cuda_nn.nn_argmin, cuda_nn.nn_min, cuda_bounds.fused_bounds,
                cuda_bounds.fused_bounds_lanes,
                cuda_bounds.fused_bounds_lanes_trimmed,
                cuda_minplus.minplus_1d, cuda_icp.icp_align,
                cuda_icp.icp_commit, cuda_fps.farthest_point_sample,
                cuda_pool.pool_commit)

    def work():
        trace.watch_mesh(mesh)
        for n, fn in enumerate(wrappers):
            fn.launches += n + 1
        mesh.c.update(collectives=5, bytes=160)

    _, (rec,) = _new_records(trace.entry("serve")(work))
    assert rec.launches == {fn.__name__: n + 1
                            for n, fn in enumerate(wrappers)}
    assert rec.mesh == dict(collectives=2, bytes=60, host_copies=0)
    _, (rec,) = _new_records(trace.entry("serve")(lambda: None))
    assert rec.mesh == {} and not any(rec.launches.values())


def test_threads_keep_their_own_requests():
    """Requests opened in several threads at once (thread hosts): each
    record holds only its own thread's spans and counts, and every record
    reaches the ring under its own id."""
    import sys
    import threading

    n_threads, n_requests = 8, 25
    span = trace.spanned("work")

    def one(k):
        for _ in range(3):
            span(trace.count)("marks", k)
            trace.to_host(torch.zeros(1))

    def worker(k):
        for _ in range(n_requests):
            trace.entry("register")(one)(k)

    last = trace.requests()[-1].id if trace.requests() else 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k + 1,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    recs = [r for r in trace.requests() if r.id > last]
    assert len(recs) == n_threads * n_requests
    assert len({r.id for r in recs}) == len(recs)
    marks = sorted(r.counts["marks"] for r in recs)
    assert marks == sorted(3 * (k + 1) for k in range(n_threads)
                           for _ in range(n_requests))
    for r in recs:
        assert r.spans["work"].calls == 3 and r.host_reads == 3


def test_outside_a_request_nothing_is_kept():
    pct = torch.as_tensor(_surface(300))
    _, recs = _new_records(lambda: coreset.build(pct, size=16))
    assert recs == []
    assert trace.to_host(torch.ones(2)).tolist() == [1.0, 1.0]


def test_no_ranges_while_off(problem):
    assert not trace.enabled()
    (_, recs), ranges = _profiled(lambda: _new_records(lambda: _run_serve(
        (problem[0], None, problem[2][1:]))))
    assert len(recs) == 1 and ranges == []


@pytest.mark.parametrize("kind", ["register", "serve"])
def test_ranges_while_on(ranged, kind):
    """Every span of the request, and its reads, is a range carrying the
    request's id and its parent span."""
    _, rec, ranges = ranged[kind]
    parsed = [trace.parse_range(n) for n in ranges]
    assert {rid for _, rid, _ in parsed} == {rec.id}
    assert {span for span, _, _ in parsed} == set(rec.spans) | {"read"}
    for name, span in rec.spans.items():
        assert sum(s == name for s, _, _ in parsed) == span.calls
        assert {p for s, _, p in parsed if s == name} == (
            set(span.under) or {None})
    reads = [p for s, _, p in parsed if s == "read"]
    assert 0 < len(reads) <= rec.host_reads
    assert set(reads) == {name for name, span in rec.spans.items()
                          if span.host_reads}


@pytest.mark.parametrize("kind", ["register", "serve"])
def test_results_bit_equal_with_ranges_on_and_off(runs, ranged, kind):
    """Poses, SSEs, stats, counts and launches of the run with the ranges
    on equal those of the run with them off."""
    (base_out, base), (out, rec) = runs[kind][:2], ranged[kind][:2]
    assert dict(rec.counts) == dict(base.counts)
    assert rec.launches == base.launches
    assert set(rec.spans) == set(base.spans)
    if kind == "register":
        (m0, R0, t0), (m1, R1, t1) = base_out, out
        assert np.array_equal(R0, R1) and np.array_equal(t0, t1)
        assert m0.best_sse == m1.best_sse
        s0, s1 = dataclasses.asdict(m0.stats), dataclasses.asdict(m1.stats)
        s0.pop("wall_seconds"), s1.pop("wall_seconds")
        assert s0 == s1
    else:
        for a, b in zip(base_out[1], out[1]):
            assert np.array_equal(a.R, b.R) and np.array_equal(a.t, b.t)
            assert (a.sse, a.certified, a.fallback_used) == (
                b.sse, b.certified, b.fallback_used)


def test_range_names_round_trip():
    assert trace.range_name("icp", 12, "seed") == "fgoicp.icp#12<seed"
    assert trace.parse_range("fgoicp.icp#12<seed") == ("icp", 12, "seed")
    assert trace.parse_range(trace.range_name("construct.fps", 3)) == (
        "construct.fps", 3, None)


SEARCH_COUNTS = ("outer_steps", "rotation_children", "rotation_pruned",
                 "icp_triggered")


@pytest.mark.parametrize("kind", ["register", "serve"])
def test_search_spans_and_counts_agree_with_stats(runs, kind):
    """A search-only request (register's pair; the serving batch's
    fallback): the outer search's span holds the inner BnB, and each search
    count equals the growth of its GoICPStats field."""
    out, rec, _, _ = runs[kind]
    assert set(rec.spans["inner_bnb"].under) == {"bnb"}
    assert rec.spans["bnb"].calls == 1
    if kind == "register":
        stats = out[0].stats
        for name in SEARCH_COUNTS:
            assert rec.counts[name] == getattr(stats, name), name
        assert rec.counts["pool_steps"] == stats.inner_loop_steps > 0
        assert rec.counts["outer_steps"] > 0
        assert rec.counts["rotation_children"] > 0
    assert set(rec.spans["bnb"].under) == ({"register"} if kind == "register"
                                           else {"fallback"})
    assert "search: outer_steps " in trace.summary(rec)
    assert f"pool_steps {rec.counts['pool_steps']}" in trace.summary(rec)


def test_seeding_certified_request_has_no_search(problem, monkeypatch):
    """A pair the multi-start seeding certifies opens the outer search's
    span, which makes no read and starts no inner BnB: no search count
    grows, and its reads are the ICPs' and construction's, as before."""
    reads = _Spy(monkeypatch, trace, "to_host",
                 lambda *tensors: len(tensors))
    cfg = Config()
    cfg.engine = _engine(icp_multi_start=True)
    pct, _, batch = problem
    (model, _, _), (rec,) = _new_records(
        lambda: register(cfg, pct, batch[1], device="cpu"))
    assert model.last_certified_gap <= model.sse_threshold
    assert model.stats.outer_steps == 0
    assert "inner_bnb" not in rec.spans
    assert rec.spans["bnb"].host_reads == 0
    for name in SEARCH_COUNTS + ("pool_steps", "inner_nodes", "bound_pairs",
                                 "bound_box_tests", "bound_bytes"):
        assert rec.counts[name] == 0, name
    assert rec.host_reads == sum(reads.calls) > 0
    assert "search:" not in trace.summary(rec)


def test_device_counts_ride_on_reads():
    """The request's device counter (here on the CPU) comes back with the
    next read after a launch, at no read of its own; only a launch that no
    read followed makes the request's end read it."""
    cpu = torch.device("cpu")
    assert trace.device_counts(cpu) is None

    def launch(pairs, tests):
        trace.device_counts(cpu).add_(torch.tensor([pairs, tests]))

    def work(read_last):
        launch(5, 7)
        trace.to_host(torch.ones(1))
        launch(1, 2)
        if read_last:
            trace.to_host(torch.ones(2))

    for read_last, reads in ((True, 2), (False, 2)):
        _, (rec,) = _new_records(
            lambda: trace.entry("register")(work)(read_last))
        assert rec.counts["bound_pairs"] == 6
        assert rec.counts["bound_box_tests"] == 9
        assert rec.host_reads == reads
    _, (rec,) = _new_records(lambda: trace.entry("register")(
        lambda: trace.to_host(torch.ones(1)))())
    assert rec.host_reads == 1 and "bound_pairs" not in rec.counts


def test_traced_search_equals_untraced(problem):
    """The same search inside a request and outside any (GoICP.run without
    its entry): equal bits, equal stats."""
    pct, pcs, _ = problem
    models = [GoICP(pct, pcs, engine=_engine(), device="cpu")
              for _ in range(2)]
    _, (rec,) = _new_records(models[0].run)
    _, recs = _new_records(lambda: GoICP.run.__wrapped__(models[1]))
    assert recs == [] and rec.counts["outer_steps"] > 0
    a, b = models
    assert a.best_sse == b.best_sse
    assert np.array_equal(a.best_rotation, b.best_rotation)
    assert np.array_equal(a.best_translation, b.best_translation)
    sa, sb = dataclasses.asdict(a.stats), dataclasses.asdict(b.stats)
    sa.pop("wall_seconds"), sb.pop("wall_seconds")
    assert sa == sb
