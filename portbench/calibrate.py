"""The readings that the limits of `check.py` are set from: the program's,
the control's and the altered answer's.

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 3 \
        [--seconds 51] [--out FILE]

In one process, for each seed: one run of the cell as `portbench.run` makes
it (a window of --seconds at the cell's load), its answers judged as the
run judges them (`check.judge`), and then the same answers twice more
through `check.judge`:
* the control: the reference in TF32 (`reference.sse_tf32`, the norm
  expansion on TF32 operands, the precision below the configuration's
  exact float32) put in the program's place, so that each answer reports
  the TF32 objective of the program's pose;
* an altered answer: each pose turned by `TURN` rad where it is produced,
  reporting the exact objective of the turned pose and its certificate
  kept, so that only `opt_excess` can tell.
Both have to come out as not correct.  One JSON line a seed, with the
window's latencies, the entry's counters and each answer's mse and
certificate.  The benchmark's own runs never run these.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

from portbench import check, reference, spec
from portbench.run import T0, run_cell

TURN = 0.2


def turned(R, angle: float = TURN) -> np.ndarray:
    """R followed by a turn of `angle` rad about the z axis."""
    c, s = np.cos(angle), np.sin(angle)
    return (np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
            @ np.asarray(R, np.float32))


def _with(it: check.Item, **answer) -> check.Item:
    return dataclasses.replace(it, answer=dataclasses.replace(it.answer,
                                                              **answer))


def control_items(items: list, device) -> list:
    """The answers with the control's objective at the program's poses."""
    return [_with(it, sse=reference.sse_tf32(it.target, it.source,
                                             it.answer.R, it.answer.t,
                                             device)) for it in items]


def altered_items(items: list, device) -> list:
    """The answers with each pose turned and its exact objective."""
    out = []
    for it in items:
        R = turned(it.answer.R)
        out.append(_with(it, R=R, sse=reference.sse(
            it.target, it.source, R, it.answer.t, device)))
    return out


def judged(kind: str, items: list, config: dict, device) -> dict:
    correct, checks = check.judge(len(items), items,
                                  float(config["mse_threshold"]),
                                  config["limits"], device)
    return {f"{kind}_correct": correct,
            **{f"{kind}_{k}": v["value"] for k, v in checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    config = spec.config(cell["config"])
    out = open(args.out, "a") if args.out else sys.stdout
    try:
        for seed in args.seeds:
            result, items, ctx = run_cell(bench, cell, seed, args.seconds, 0,
                                          "cuda", T0)
            line = {"workload": args.workload, "seed": seed,
                    "correct": result["correct"],
                    **{k: v["value"] for k, v in result["checks"].items()},
                    **judged("control", control_items(items, "cuda"),
                             config, "cuda"),
                    **judged("altered", altered_items(items, "cuda"),
                             config, "cuda"),
                    "metrics": result["metrics"], "device": result["device"],
                    "requests": ctx["requests"], "pairs": ctx["pairs"],
                    "latencies": ctx["latencies"],
                    "counters": ctx["counters"],
                    "answers": [[it.answer.sse / len(it.source),
                                 it.answer.certified] for it in items]}
            print(json.dumps(line), file=out, flush=True)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
