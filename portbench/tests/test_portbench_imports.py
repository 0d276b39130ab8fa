"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module name (so `fgoicp_tpu_torch` is not
`fgoicp_tpu`); the yardstick imports nothing of the program."""

import ast
import pathlib
import subprocess
import sys

import pytest

from portbench import run, spec

HERE = spec.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "fgoicp_tpu"}
# The yardstick: generators (kinds and clouds), reference, comparison,
# peaks, profile reduction and the readers; only the entries and the run
# reach the program.
YARDSTICK = ["gen.py", "traffic.py", "reference.py", "check.py",
             "roofline.py", "trace.py", "readers.py", "spec.py"] + sorted(
    str(p.relative_to(HERE)) for sub in ("kinds", "clouds", "metrics")
    for p in (HERE / sub).glob("*.py"))


def _top_names(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_jax_import(path):
    assert not _top_names(path) & FORBIDDEN


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(name):
    assert "fgoicp_tpu_torch" not in _top_names(HERE / name)


def test_whole_name_comparison():
    assert run.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    assert "fgoicp_tpu_torch".split(".")[0] not in FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import portbench.reference, portbench.check; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('fgoicp_tpu_torch', 'fgoicp_tpu', 'jax', 'jaxlib', 'flax')); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_a_cell_run_loads_no_jax():
    """A tiny run of the main cell on the CPU, in a fresh process, leaves
    no JAX module in sys.modules."""
    code = ("import sys, time; from portbench import run; "
            "from portbench.tests.tiny import tiny; "
            "b, c, cfg, mix = tiny('bunny_toml.random_pose'); "
            "run.run_cell(b, c, 5, 0.1, 0, 'cpu', time.perf_counter(), cfg, "
            "mix); print(run.forbidden_modules()); "
            "sys.exit(1 if run.forbidden_modules() else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
