"""The metric arithmetic on a synthetic event list and context."""

import numpy as np
import pytest

from portbench import readers, roofline, spec
from portbench import trace as tr

MS = 1_000_000  # ns


def _events():
    """A 10 ms window: kernels at 1-3 ms (nn) and 2-4 ms (bounds,
    overlapping), a copy at 6-7 ms; three launches; a benchmark span and a
    host op over the long gap 7-10 ms; the device-side annotation of the
    span, which is no activity."""
    nn = "void (anonymous namespace)::nn_kernel<true, false>(float const*)"
    return [
        (tr.WINDOW, False, 0, 10 * MS),
        (nn, True, 1 * MS, 3 * MS),
        ("void (anonymous namespace)::bounds_lanes_kernel(float*)", True,
         2 * MS, 4 * MS),
        ("Memcpy DtoH (Device -> Pinned)", True, 6 * MS, 7 * MS),
        ("cudaLaunchKernel", False, 1 * MS - 5000, 1 * MS - 1000),
        ("cudaLaunchKernel", False, 2 * MS - 5000, 2 * MS - 1000),
        ("cuLaunchKernel", False, 5 * MS, 5 * MS + 1000),
        ("portbench.icp", False, 6 * MS, 10 * MS),
        ("portbench.icp", True, 6 * MS, 10 * MS),
        ("aten::item", False, 7 * MS, 9 * MS),
        ("outside", True, 11 * MS, 12 * MS),
    ]


def test_reduce():
    p = tr.reduce(_events())
    assert p["window_s"] == pytest.approx(0.010)
    assert p["busy_s"] == pytest.approx(0.004)     # 1-4 and 6-7 ms
    assert p["launches"] == 3
    assert p["kernel_s"]["nn_kernel<true, false>"] == pytest.approx(0.002)
    assert p["kernel_s"]["bounds_lanes_kernel"] == pytest.approx(0.002)
    labels = dict(p["idle_gaps"])
    assert list(labels)[0] == "icp / aten::item"   # 7-10 ms, longest
    assert labels["icp / aten::item"] == pytest.approx(0.003)
    assert sorted(labels.values(), reverse=True) == pytest.approx(
        [0.003, 0.002, 0.001])
    assert p["device_ops"][0][1] == pytest.approx(0.002)


def test_reduce_needs_the_window():
    with pytest.raises(ValueError):
        tr.reduce([("x", True, 0, 1)])


def test_nn_work_and_bound():
    flops, nbytes = roofline.nn_work("nn_argmin", 1000, 2000)
    assert flops == 8 * 1000 * 2000
    assert nbytes == 12 * 3000 + 8 * 1000
    assert roofline.nn_work("nn_min", 1000, 2000)[1] == 12 * 3000 + 4 * 1000
    # Large shapes are bound by operations, tiny ones by bytes.
    assert roofline.bound_s(*roofline.nn_work("nn_min", 10 ** 6, 4096)) \
        == pytest.approx(8 * 4096e6 / 67e12)
    assert roofline.bound_s(*roofline.nn_work("nn_min", 1, 1)) \
        == pytest.approx(28 / 3.35e12)


def _ctx():
    p = tr.reduce(_events())
    calls = [("nn_argmin", 48000, 1024), ("nn_min", 3000, 18000)]
    p.update(requests=2, pairs=4, nn_calls=calls)
    return {"setup_s": 9.5, "window_s": 20.0, "requests": 40, "pairs": 160,
            "later_requests": 40, "later_pairs": 160,
            "latencies": [float(i) for i in range(1, 101)],
            "certified": 150,
            "counters": {"seed_seconds": 8.0, "fallback_seconds": 4.0},
            "spans_s": {"construct": 2.0, "icp": 10.0, "inner_bnb": 0.0},
            "profile": p}


def test_readers():
    ctx = _ctx()
    read = lambda name: spec.reader(name)(ctx)
    assert read("setup_s") == 9.5
    assert read("register_s") == pytest.approx(20.0 / 150)
    assert read("register_p90_s") == pytest.approx(90.1)
    assert read("pairs_per_s") == pytest.approx(7.5)
    assert read("construct_ms.register") == pytest.approx(50.0)
    assert read("icp_ms.register") == pytest.approx(250.0)
    assert read("inner_bnb_ms.register") == 0.0
    assert read("seed_ms.register") == pytest.approx(200.0)
    assert read("seed_ms.serve") == pytest.approx(50.0)
    assert read("fallback_ms.serve") == pytest.approx(25.0)
    bound = roofline.nn_bound_s(ctx["profile"]["nn_calls"])
    for s in ("register", "serve"):
        assert read(f"nn_roofline.{s}") == pytest.approx(100 * bound / 0.002)
        assert read(f"device_idle_pct.{s}") == pytest.approx(60.0)
        assert read(f"launches_per_pair.{s}") == pytest.approx(0.75)


def test_readers_find_nothing_without_a_profile():
    ctx = dict(_ctx(), profile=None, spans_s={})
    for m in spec.benchmark()["per_layer"]:
        if m["source"] != "program_counter":
            assert spec.reader(m["name"])(ctx) is None, m["name"]


def test_roofline_silent_without_nn_time():
    ctx = _ctx()
    ctx["profile"]["kernel_s"] = {"bounds_lanes_kernel": 0.002}
    assert readers.nn_roofline(ctx) is None


def test_nn_calls_keep_the_program_counters():
    """The recorder's stand-ins carry the wrappers' own counters, which
    the program's wrappers update through their module-level names."""
    import collections
    import types

    mod = types.SimpleNamespace()

    def nn_min(q, p):
        mod.nn_min.launches += 1
        mod.nn_min.shapes[(len(q), len(p))] += 1
        return "d2"

    nn_min.launches, nn_min.shapes = 5, collections.Counter()
    mod.nn_min = nn_min
    mod.nn_argmin = lambda q, p: ("d2", "idx")
    rec = tr.NNCalls(mod)
    rec.install()
    assert mod.nn_min(np.zeros((3, 3)), np.zeros((7, 3))) == "d2"
    mod.nn_argmin(np.zeros((2, 3)), np.zeros((4, 3)))
    rec.restore()
    assert mod.nn_min is nn_min and nn_min.launches == 6
    assert nn_min.shapes == {(3, 7): 1}
    assert rec.calls == [("nn_min", 3, 7), ("nn_argmin", 2, 4)]
