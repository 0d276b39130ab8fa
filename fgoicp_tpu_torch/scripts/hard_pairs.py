"""The hard scan pairs: the counterpart of the JAX package's
scripts/hard_pairs.py.

The classic Go-ICP regime: turntable scans 90 degrees apart with partial
overlap, where seeding cannot certify and the trimmed BnB must do real
work.  The real pairs read the reference's Stanford bunny scans from
--data (bun000 against bun090, chin or bun045; ground truth from the
published registration: bun090 about 90.2 degrees about -y, chin about
58.6 degrees about (-0.90, 0.43, 0.01)).  Without --data the pair is
`workloads.hard_synth`, a seeded stand-in at the same sizes whose pose is
known, and each run also reports its pose errors against it: of the
certified pose, and of its basin, one converged trimmed ICP from it (500
iterations to a 1e-7 relative change; the engine's final ICP stops at
icp_convergence_final, which on a trimmed partial overlap can leave the
pose short of the optimum).

    python -m fgoicp_tpu_torch.scripts.hard_pairs [--pair synth|090|chin|045]
        [--trim 0.5] [--subsample 0.25] [--tgt-subsample 0.5] [--mse 1e-4]
        [--device-outer] [--runs 2] [--data DIR] [--device cuda]

One JSON line a run (the first is cold): wall, mse, the certificate gap,
the seeding's sse (the root's gap: the root lb is 0), translation nodes,
rotation children, outer steps, ICP runs, and the pose as angle, axis, R
and t.  --scale shrinks the synthetic pair's point counts (the tests run it
tiny).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import workloads

SCANS = {"090": "bun090.ply", "chin": "chin.ply", "045": "bun045.ply"}


def axis_angle(R):
    """(angle in degrees, unit axis) of a rotation matrix."""
    R = np.asarray(R, np.float64)
    ang = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)))
    axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                     R[1, 0] - R[0, 1]])
    n = np.linalg.norm(axis)
    return float(ang), (axis / n if n > 1e-9 else axis)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pair", default=None,
                    choices=["synth", *SCANS],
                    help="default: 090 with --data, synth without")
    ap.add_argument("--trim", type=float, default=0.5)
    ap.add_argument("--subsample", type=float, default=0.25)
    ap.add_argument("--tgt-subsample", type=float, default=0.5)
    ap.add_argument("--mse", type=float, default=1e-4)
    ap.add_argument("--device-outer", action="store_true")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--data", default="",
                    help="the reference's data/ directory (real scans)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="shrink the synthetic pair's point counts")
    ap.add_argument("--device", default="cuda")
    return ap


def load_pair(args):
    """(pct, pcs, truth or None, label); truth = (R, t, span)."""
    pair = args.pair or ("090" if args.data else "synth")
    if pair == "synth":
        n = lambda k: max(16, int(k * args.scale))
        pct, pcs, R, t, span = workloads.hard_synth(n(20000), n(10000))
        return pct, pcs, (R, t, span), "synth"
    workloads.need_data(f"--pair {pair}", args.data)
    from ..io import load_cloud
    src = SCANS[pair]
    return (load_cloud(f"{args.data}/bunny/bun000.ply", args.tgt_subsample,
                       seed=0),
            load_cloud(f"{args.data}/bunny/{src}", args.subsample, seed=1),
            None, pair)


def seed_recorder(model):
    """Record the engine's best sse after its seeding (the root's gap)."""
    seen = {}
    real = model._initial_icp

    def recorded():
        out = real()
        seen["seed_sse"] = float(model.best_sse)
        return out
    model._initial_icp = recorded
    return seen


def basin(model):
    """(R, t) in the world frame: a converged trimmed ICP from the model's
    certified pose on the full clouds."""
    from ..models.icp import icp_register
    _, Rb, tb = icp_register(
        model.pct, model.pcs, model.best_rotation, model.best_translation,
        max_iter=500, convergence_threshold=1e-7, trim_keep=model.trim_keep)
    tb = model.norm.restore_translation(Rb, tb)
    return Rb.cpu().numpy(), tb.cpu().numpy()


def run(argv=None, engine=None) -> list:
    """One dict a run (the printed lines).  engine: an EngineConfig in
    place of the default (whose outer_mode --device-outer sets)."""
    args = build_parser().parse_args(argv)
    import torch
    from ..config import EngineConfig
    from ..models.goicp import GoICP
    from ..utils import logging as log
    log.set_quiet(True)

    pct, pcs, truth, label = load_pair(args)
    dev = torch.device(args.device)
    eng = engine or EngineConfig(
        outer_mode="device" if args.device_outer else "host")
    lines = []
    for i in range(args.runs):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        model = GoICP(pct, pcs, engine=eng, mse_threshold=args.mse,
                      trim_fraction=args.trim, device=dev)
        seen = seed_recorder(model)
        R, t = model.run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        ang, axis = axis_angle(R)
        s = model.stats
        line = {
            "run": i, "pair": label, "target_points": len(pct),
            "source_points": len(pcs), "trim": args.trim, "mse_threshold":
            args.mse, "outer_mode": eng.outer_mode, "device": str(dev),
            "wall_s": wall, "mse": float(model.mse),
            "sse": float(model.best_sse),
            "sse_threshold": model.sse_threshold,
            "gap": model.last_certified_gap,
            "certified": bool(model.last_certified_gap
                              <= model.sse_threshold),
            "seed_sse": seen.get("seed_sse"),
            "nodes": s.translation_nodes,
            "rotation_children": s.rotation_children,
            "outer_steps": s.outer_steps, "inner_steps": s.inner_loop_steps,
            "icp_runs": s.icp_runs, "angle_deg": ang,
            "axis": [float(a) for a in axis],
            "R": np.asarray(R, np.float64).tolist(),
            "t": [float(v) for v in np.asarray(t)]}
        if truth is not None:
            R_true, t_true, span = truth
            err = lambda R_, t_: (
                float(np.abs(np.asarray(R_) - R_true).max()),
                float(np.abs(np.asarray(t_) - t_true).max() / span))
            line["r_err"], line["t_err_span"] = err(R, t)
            line["basin_r_err"], line["basin_t_err_span"] = err(*basin(model))
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
