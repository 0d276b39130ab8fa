"""Serving experiments: the counterpart of the JAX package's
scripts/serving_experiment.py.

Drives `models/serving.py::RegistrationService` end to end:
  ragged   : sources of different sizes (4,000 to 9,000 points) in one call,
             each the cloud subsampled at a random pose;
  fallback : half-space partial views (`make_partial_scans`) at random
             poses, registered by a trimmed service (--trim): multi-start
             seeding cannot certify every view, and the uncertified ones
             take the trimmed BnB fallback on the shared coreset.
The cloud is the Artec3D skull from --data (data/artec3d/data_skull.ply)
or, without it, `workloads.skull_synth`; the target is 6,000 of its
points, and the sources are drawn as the JAX script draws them.

    python -m fgoicp_tpu_torch.scripts.serving_experiment [--pairs 16]
        [--mode ragged|fallback] [--trim 0.3] [--runs 2] [--seed 11]
        [--data DIR] [--device cuda]

One JSON line a run (the first is cold): wall, pairs/s, certified pairs,
fallbacks and exact recoveries (R max-abs error < 5e-3 and t error <
2e-3 x the cloud's span, the JAX script's tolerances), with the service's
seeding and fallback seconds and each pair's result.  --points shrinks the
cloud (the tests).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import workloads

SKULL = "artec3d/data_skull.ply"


def random_pose(rng, span):
    """A uniform random rotation (QR) and a translation in +-0.25 span."""
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    R = (q * np.sign(np.diag(q))[None, :]).astype(np.float32)
    if np.linalg.det(R) < 0:
        R[:, 0] *= -1
    t = rng.uniform(-0.25, 0.25, size=3).astype(np.float32) * span
    return R, t


def make_partial_scans(cloud, b, ns, rng, span):
    """Half-space partial views at random poses: keep the points on one
    side of a random plane through the centroid (what a single-view
    scanner sees), subsample, then apply a random SE(3).  Returns
    (sources, Rs, ts) with R @ source + t on the cloud."""
    sources, Rs, ts = [], [], []
    mu = cloud.mean(axis=0)
    for _ in range(b):
        n = rng.normal(size=3)
        n /= np.linalg.norm(n)
        part = cloud[(cloud - mu) @ n > 0]
        idx = rng.choice(len(part), size=min(ns, len(part)), replace=False)
        R, t = random_pose(rng, span)
        sources.append((part[idx] - t) @ R)
        Rs.append(R)
        ts.append(t)
    return sources, Rs, ts


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=16)
    ap.add_argument("--mode", default="fallback",
                    choices=("ragged", "fallback"))
    ap.add_argument("--trim", type=float, default=0.3)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--data", default="",
                    help="the reference's data/ directory (the skull)")
    ap.add_argument("--points", type=int, default=None,
                    help="subsample the cloud to this many points")
    ap.add_argument("--device", default="cuda")
    return ap


def experiment(args):
    """(target, sources, Rs, ts, span, service keyword arguments) of a
    mode, drawn as the JAX script draws them.  The target, the ragged
    sizes and the poses scale with the cloud (6,000 of 98,359 points)."""
    if args.data:
        workloads.need_data("the skull", args.data)
        from ..io import load_cloud
        cloud = load_cloud(f"{args.data}/{SKULL}", 1.0, seed=0)
    else:
        cloud = workloads.skull_synth()
    if args.points:
        cloud = cloud[np.random.default_rng(0).choice(
            len(cloud), size=args.points, replace=False)]
    frac = len(cloud) / workloads.SKULL_POINTS
    n = lambda k: max(16, int(round(k * min(1.0, frac))))
    rng = np.random.default_rng(args.seed)
    pct = cloud[rng.choice(len(cloud), size=n(6000), replace=False)]
    span = float(np.ptp(cloud, axis=0).max())
    if args.mode == "ragged":
        sizes = rng.integers(n(4000), n(9000), size=args.pairs)
        sources, Rs, ts = [], [], []
        for ns in sizes:
            si = rng.choice(len(cloud), size=int(ns), replace=False)
            R, t = random_pose(rng, span)
            sources.append((cloud[si] - t) @ R)
            Rs.append(R)
            ts.append(t)
        return pct, sources, Rs, ts, span, dict(mse_threshold=1e-3)
    sources, Rs, ts = make_partial_scans(cloud, args.pairs, n(6000), rng,
                                         span)
    return (pct, np.stack(sources), Rs, ts, span,
            dict(mse_threshold=1e-3, trim_fraction=args.trim))


def recovered(r, R_true, t_true, span) -> bool:
    """The JAX script's exact recovery: R < 5e-3 and t < 2e-3 x span (the
    subsampled target's NN floor moves the optimum by a span-relative
    amount however small the true shift)."""
    return bool(np.abs(r.R - R_true).max() < 5e-3
                and np.abs(r.t - t_true).max() < 2e-3 * span)


def run(argv=None, engine=None) -> list:
    """One dict a run (the printed lines); engine: an EngineConfig for the
    service in place of the default."""
    args = build_parser().parse_args(argv)
    import torch
    from ..models import serving
    from ..utils import logging as log
    log.set_quiet(True)

    pct, sources, Rs, ts, span, kw = experiment(args)
    dev = torch.device(args.device)
    srv = serving.RegistrationService(pct, engine=engine, device=dev, **kw)
    lines = []
    for run_i in range(args.runs):
        before = srv.stats.__dict__.copy()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        results = srv.register(sources)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        after = srv.stats.__dict__
        line = {
            "run": run_i, "mode": args.mode, "device": str(dev),
            "pairs": len(results), "target_points": len(pct),
            "trim": kw.get("trim_fraction", 0.0), "wall_s": wall,
            "pairs_per_s": len(results) / wall,
            "certified": sum(r.certified for r in results),
            "fallbacks": sum(r.fallback_used for r in results),
            "exact_recoveries": sum(recovered(r, R, t, span) for r, R, t
                                    in zip(results, Rs, ts)),
            **{k: after[k] - before[k] for k in (
                "certified_by_seeding", "seed_seconds",
                "fallback_seconds")},
            "per_pair": [dict(certified=bool(r.certified),
                              fallback=bool(r.fallback_used),
                              mse=float(r.mse),
                              recovered=recovered(r, R, t, span),
                              R=np.asarray(r.R, np.float64).tolist(),
                              t=np.asarray(r.t, np.float64).tolist())
                         for r, R, t in zip(results, Rs, ts)]}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
