"""Runs on the card: one short run of each cell through the command's own
path, correct and reporting its metrics.  Skips without a CUDA card.

    python -m pytest portbench/tests -q -m card
"""

import json
import subprocess
import sys

import pytest

from portbench import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    names = {m["name"] for m in spec.metrics_of(spec.benchmark(), cell,
                                                 "end_to_end")}
    assert set(result["metrics"]) == names
