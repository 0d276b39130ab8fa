"""Phase-level wall-clock breakdown of a GoICP run.

Wraps the engine's phases with timers and prints where the seconds go:
the initial ICP, the inner-BnB calls, the triggered refine ICPs, the child
spawning (with its claim-leaf ICPs) and the final ICP, the rest as host
bookkeeping; plus the ms per ICP iteration (the ICP phases' seconds over
their Procrustes steps, one an ICP iteration, from the ICP's
"icp_iterations" count) and per inner BnB step.  On a card every phase
edge synchronizes the device first: launches are asynchronous, and without
it a phase's device time is billed to whichever phase next reads the host.

    python -m fgoicp_tpu_torch.scripts.profile_phases [--workload smoke]
        [--device cuda] [--runs 2] [engine flags]

Engine flags: the JAX tool's seven with its defaults, --source-coreset 0
(no source clusters), --pool-lanes 1024, --rotation-batch 16,
--icp-max-iter 100, --icp-width 16, --pool-capacity 32768 and
--icp-search-subsample 2048; and --translation-min-span,
--rotation-min-span, --pool-update, --outer-mode, --no-multi-start.  One
JSON line per run (the first is cold), with the seven settings under
"engine".  Workloads: see `workloads` (the real scans need --data).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import workloads

PHASES = ("initial_icp", "inner_bnb", "refine_icp", "spawn", "final_icp")
_METHODS = {"initial_icp": "_initial_icp", "inner_bnb": "_evaluate_children",
            "refine_icp": "_refine_candidates", "spawn": "_spawn_children",
            "final_icp": "_final_icp"}
_ICP_PHASES = ("initial_icp", "refine_icp", "spawn", "final_icp")


def timed(model, sync):
    """Timers around the engine's phases (instance attributes shadowing
    its methods) and, by phase, the Procrustes steps the phase runs: its
    `icp_batched` calls' "icp_iterations" counts (one step an iteration),
    read from `trace.count` while the phase runs.  Returns (seconds by
    phase, calls by phase, Procrustes steps by phase); the counts fill as
    the model runs."""
    from ..utils import trace
    acc = {k: 0.0 for k in PHASES}
    calls = {k: 0 for k in PHASES}
    steps = {k: 0 for k in PHASES}
    current = []
    real_count = trace.count

    def counted(name, n=1):
        if current and name == "icp_iterations":
            steps[current[-1]] += n
        return real_count(name, n)

    def wrap(name, fn):
        def inner(*a, **kw):
            sync()
            t0 = time.perf_counter()
            current.append(name)
            trace.count = counted
            try:
                out = fn(*a, **kw)
                sync()
            finally:
                current.pop()
                if not current:
                    trace.count = real_count
            acc[name] += time.perf_counter() - t0
            calls[name] += 1
            return out
        return inner

    for name, method in _METHODS.items():
        setattr(model, method, wrap(name, getattr(model, method)))
    return acc, calls, steps


# scripts/profile_phases.py's engine flags and defaults.
JAX_TOOL_DEFAULTS = {"source-coreset": 0, "pool-lanes": 1024,
                     "rotation-batch": 16, "icp-max-iter": 100,
                     "icp-width": 16, "pool-capacity": 32768,
                     "icp-search-subsample": 2048}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="smoke", choices=workloads.NAMES)
    ap.add_argument("--data", default="",
                    help="the reference's data/ directory (real scans)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="shrink the synthetic workloads' point counts")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--proxy-size", type=int, default=1024)
    ap.add_argument("--runs", type=int, default=2)
    # The JAX tool's engine flags with its defaults (source clusters off).
    for flag, default in JAX_TOOL_DEFAULTS.items():
        ap.add_argument(f"--{flag}", type=int, default=default,
                        help=f"engine setting (default {default})")
    for flag in ("translation-min-span", "rotation-min-span"):
        ap.add_argument(f"--{flag}", type=float, default=None,
                        help="engine override (default: EngineConfig's)")
    ap.add_argument("--pool-update", default=None, choices=("sort", "merge"))
    ap.add_argument("--outer-mode", default=None, choices=("host", "device"))
    ap.add_argument("--no-multi-start", action="store_true")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="the engine's log lines (off: the JSON only)")
    return ap


def engine_of(args):
    """EngineConfig with the tool's engine settings (the JAX tool's seven
    always; the span, update and outer-mode flags when given)."""
    from ..config import EngineConfig
    kw = {k.replace("-", "_"): getattr(args, k.replace("-", "_"))
          for k in JAX_TOOL_DEFAULTS}
    kw.update({k: v for k, v in (
        ("translation_min_span", args.translation_min_span),
        ("rotation_min_span", args.rotation_min_span),
        ("pool_update", args.pool_update), ("outer_mode", args.outer_mode))
        if v is not None})
    if args.no_multi_start:
        kw["icp_multi_start"] = False
    return EngineConfig(**kw)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch
    from ..models.goicp import GoICP
    from ..utils import logging as log
    log.set_quiet(not args.verbose)

    dev = torch.device(args.device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    pct, pcs, mse, trim = workloads.load(args.workload, args.data,
                                         args.scale)
    eng = engine_of(args)
    for run in range(args.runs):
        sync()
        t0 = time.perf_counter()
        model = GoICP(pct, pcs, mse_threshold=mse, engine=eng,
                      proxy_size=args.proxy_size, trim_fraction=trim,
                      device=dev)
        sync()
        setup = time.perf_counter() - t0
        acc, calls, steps = timed(model, sync)
        t0 = time.perf_counter()
        model.run()
        sync()
        wall = time.perf_counter() - t0
        s = model.stats
        e = model.engine
        icp_s = sum(acc[k] for k in _ICP_PHASES)
        icp_steps = sum(steps[k] for k in _ICP_PHASES)
        print(json.dumps({
            "run": run, "workload": args.workload, "device": str(dev),
            "engine": {k: getattr(e, k) for k in (
                f.replace("-", "_") for f in JAX_TOOL_DEFAULTS)},
            "setup_s": setup, "wall_s": wall, "mse": float(model.mse),
            "sse": float(model.best_sse),
            "certified": bool(model.last_certified_gap is not None and
                              model.last_certified_gap
                              <= model.sse_threshold),
            "nodes": s.translation_nodes, "inner_steps": s.inner_loop_steps,
            "dropped": s.dropped_nodes, "outer_steps": s.outer_steps,
            "icp_runs": s.icp_runs, "phases_s": acc,
            "other_s": wall - sum(acc.values()), "calls": calls,
            "procrustes_steps": steps,
            "ms_per_icp_iteration": (1e3 * icp_s / icp_steps
                                     if icp_steps else None),
            "ms_per_inner_step": (1e3 * acc["inner_bnb"]
                                  / s.inner_loop_steps
                                  if s.inner_loop_steps else None)}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
