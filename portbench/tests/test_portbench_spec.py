"""BENCHMARK.json against the contract, and the harness finding every
configuration, mix and metric by name."""

import json
import re

import pytest

from portbench import spec, traffic

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(names)) == len(names)
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_finds_its_files(cell):
    w = spec.cell(BENCH, cell)
    config = spec.config(w["config"])
    mix = spec.traffic(w["traffic"])
    assert spec.entry(config["entry"]).build
    assert {"missing", "sse_gap", "opt_excess"} \
        <= set(config["limits"])
    assert callable(spec.kind(mix["kind"]))
    assert callable(spec.cloud(config["cloud"]["kind"]))
    e2e = [m["name"] for m in spec.metrics_of(BENCH, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = spec.metrics_of(BENCH, cell, "per_layer")
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])
    for m in spec.metrics_of(BENCH, cell, "end_to_end") + layer:
        assert callable(spec.reader(m["name"]))


def test_metric_workloads_name_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for c in BENCH["configs"]:
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


NEW_KIND = """
from portbench import gen, traffic


def build(config, mix, seed):
    cloud = traffic.model_cloud(config)
    rng = gen.rng_of(seed, traffic.POOL)
    reqs = []
    for _ in range(int(mix["pool"]) + 1):
        R, t = gen.random_pose(rng, gen.span_of(cloud), 0.0)
        half = cloud[cloud[:, 0] > float(mix["cut"])]
        reqs.append(traffic.Request([gen.moved(half, R, t)], [(R, t)],
                                    target=cloud))
    return traffic.Workload(None, reqs[0], reqs[1:])
"""

NEW_CLOUD = """
def make(rng, spec):
    return rng.normal(size=(int(spec["points"]), 3)).astype("float32")
"""


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    """A configuration with a cloud of a new kind, a mix of a new kind of
    traffic, and a metric, each added as a new file, are found by name and
    run, with no edit to a file the harness has."""
    for sub in ("configs", "traffic", "metrics", "kinds", "clouds"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "new_config.json").write_text(json.dumps(
        {"entry": "register", "mse_threshold": 1e-3,
         "cloud": {"kind": "blob", "seed": 1, "points": 50}}))
    (tmp_path / "traffic" / "new_mix.json").write_text(
        json.dumps({"kind": "cut_views", "cut": 0.0, "pool": 2,
                    "trace_requests": 1}))
    (tmp_path / "kinds" / "cut_views.py").write_text(NEW_KIND)
    (tmp_path / "clouds" / "blob.py").write_text(NEW_CLOUD)
    (tmp_path / "metrics" / "new_metric.cell.py").write_text(
        "def read(ctx):\n    return 2.0 * ctx['requests']\n")
    monkeypatch.setattr(spec, "HERE", tmp_path)
    config = spec.config("new_config")
    mix = spec.traffic("new_mix")
    work = traffic.build(config, mix, 2 ** 31 + 7)
    assert len(work.pool) == 2 and work.pool[0].target.shape == (50, 3)
    assert 0 < len(work.pool[0].sources[0]) < 50
    assert spec.reader("new_metric.cell")({"requests": 3}) == 6.0
    bench = {"per_layer": [{"name": "a"}, {"name": "b", "workloads": ["x"]},
                           {"name": "c", "workloads": ["y"]}]}
    assert [m["name"] for m in spec.metrics_of(bench, "x", "per_layer")] \
        == ["a", "b"]
