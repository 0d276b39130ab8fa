"""Finds what a cell names, by name: `BENCHMARK.json` at the root of the
checkout, the configuration `configs/<name>.json`, the traffic mix
`traffic/<name>.json`, the generator of the mix's `kind`
(`kinds/<kind>.py`), the maker of the configuration's cloud
(`clouds/<kind>.py`), the metric readers `metrics/<name>.py` and the
entries `entries/<entry>.py`, all under `HERE`.  Adding a cell, a mix, a kind of traffic, a
cloud, a configuration or a metric adds files; none here needs an edit."""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (one of "
                   f"{[w['name'] for w in bench['workloads']]})")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def entry(kind: str):
    """The module that drives the program's entry `kind`."""
    return importlib.import_module(f"portbench.entries.{kind}")


def module(folder: str, name: str):
    """The module `<folder>/<name>.py`, loaded from its path (a metric's
    file name may hold dots)."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The `read(ctx)` function of the metric `name`."""
    return module("metrics", name).read


def kind(name: str):
    """The `build(config, mix, seed) -> traffic.Workload` of a mix's
    `kind`."""
    return module("kinds", name).build


def cloud(name: str):
    """The `make(rng, spec) -> [n, 3] float32` of a configuration's
    `cloud.kind`."""
    return module("clouds", name).make


def metrics_of(bench: dict, cell_name: str, kind: str) -> list:
    """The `end_to_end` or `per_layer` metrics a cell reports: those with
    no `workloads` list, and those whose list names the cell."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]
