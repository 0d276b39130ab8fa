"""CLI entry: `python -m fgoicp_tpu_torch -c <config.toml> [-v] [--seed N]
[--resume] [--debug-checks] [--serve GLOB] [--device cuda|cpu]`.

Flag surface of the JAX package's CLI (and the reference app,
src/main.cpp:8-58) for the ported paths: required -c/--config TOML path,
-v/--verbose debug logging, --seed for deterministic subsampling, --resume
from engine.checkpoint_path, --debug-checks for the search-state sanitizer,
--serve for the batched serving mode, plus --device (default cuda; `cuda`
without a card raises).  Writes the [io] output result TOML and the [io]
visualization PLY when set.  The profiling, NaN-debugging and mesh flags are
not offered yet.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from . import __version__
from .config import Config
from .io import load_cloud, write_ply
from .models.goicp import GoICP
from .utils import logging as log


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fgoicp_tpu_torch",
        description="Fast Go-ICP in PyTorch with CUDA kernels: "
                    "globally-optimal point-cloud registration")
    p.add_argument("-c", "--config", required=True,
                   help="Path to the TOML configuration file")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Enable debug-level logging")
    p.add_argument("--seed", type=int, default=None,
                   help="Override engine.seed (subsampling/backends)")
    p.add_argument("--resume", action="store_true",
                   help="Resume from engine.checkpoint_path if it exists")
    p.add_argument("--debug-checks", action="store_true",
                   help="Enable the search-state sanitizer "
                        "(utils/sanitize.py): frontier structure, "
                        "lb <= ub bracketing, and incumbent faithfulness "
                        "validated every outer step")
    p.add_argument("--serve", metavar="GLOB", default="",
                   help="Serving mode: register EVERY cloud matching the "
                        "glob against the config's [io] target in one "
                        "batched seeding call (models/serving.py) instead "
                        "of the single [io] source.  Writes one [pair.N] "
                        "section per cloud to [io] output; ragged clouds "
                        "are seeded-subsampled to a common size")
    p.add_argument("--device", default="cuda",
                   help="Torch device to run on (default: cuda)")
    p.add_argument("--version", action="version",
                   version=f"%(prog)s {__version__}")
    return p


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)
    log.set_verbose(args.verbose)
    cfg = Config.from_toml(args.config)
    if args.debug_checks:
        cfg.engine.debug_checks = True
    if args.seed is not None:
        cfg.engine.seed = args.seed

    pct = load_cloud(cfg.io.target, cfg.params.target_subsample,
                     seed=cfg.engine.seed)
    log.info(f"Target point cloud ({len(pct)}) loaded from {cfg.io.target}")
    if args.serve:
        return _run_serve(cfg, args, pct)
    pcs = load_cloud(cfg.io.source, cfg.params.source_subsample,
                     seed=cfg.engine.seed + 1)
    log.info(f"Source point cloud ({len(pcs)}) loaded from {cfg.io.source}")

    model = GoICP(
        pct, pcs, lut_resolution=cfg.params.lut_resolution,
        mse_threshold=cfg.params.mse_threshold, engine=cfg.engine,
        trim_fraction=(cfg.params.trim_fraction if cfg.params.trim else 0.0),
        device=args.device)
    if args.resume and cfg.engine.checkpoint_path and \
            os.path.exists(cfg.engine.checkpoint_path):
        model.load_checkpoint(cfg.engine.checkpoint_path)
    t0 = time.time()
    R, t = model.run()
    elapsed = time.time() - t0
    log.info(f"Registration completed in {elapsed:.3f}s "
             f"({model.stats.cubes_per_second:.0f} cubes/s)")

    if cfg.io.output:
        _write_result(cfg.io.output, R, t, model, elapsed)
        log.info(f"Result written to {cfg.io.output}")
    if cfg.io.visualization:
        aligned = np.asarray(pcs, np.float32) @ np.asarray(R, np.float32).T \
            + np.asarray(t, np.float32)
        write_ply(cfg.io.visualization, aligned)
        log.info(f"Transformed source written to {cfg.io.visualization}")
    return 0


def _run_serve(cfg: Config, args, pct) -> int:
    """Serving mode: batched registration of every glob match against the
    config target.  Returns 0 when every pair certified, 1 when the glob
    matched nothing, 2 otherwise."""
    import glob

    from .models import serving

    paths = sorted(glob.glob(args.serve))
    if not paths:
        log.error(f"--serve matched no files: {args.serve!r}")
        return 1
    clouds = [load_cloud(p, cfg.params.source_subsample,
                         seed=cfg.engine.seed + 1 + i)
              for i, p in enumerate(paths)]
    # Seeded subsample of ragged clouds down to the smallest: basin finding
    # is insensitive to it, and a BnB fallback registers the subsampled
    # cloud, as the reference's own source_subsample does.
    ns = min(len(c) for c in clouds)
    rng = np.random.default_rng(cfg.engine.seed + 31)
    batch = np.stack([
        c if len(c) == ns else c[rng.choice(len(c), ns, replace=False)]
        for c in clouds])
    log.info(f"Serving {len(paths)} clouds ({ns} pts each) against "
             f"{len(pct)}-pt target")
    srv = serving.RegistrationService(
        pct, mse_threshold=cfg.params.mse_threshold, engine=cfg.engine,
        trim_fraction=(cfg.params.trim_fraction if cfg.params.trim else 0.0),
        device=args.device)
    t0 = time.time()
    results = srv.register(batch)
    elapsed = time.time() - t0
    n_cert = sum(r.certified for r in results)
    n_fb = sum(r.fallback_used for r in results)
    log.info(f"Registered {len(results)} pairs in {elapsed:.3f}s "
             f"({len(results) / elapsed:.2f} pairs/s): {n_cert} certified, "
             f"{n_fb} BnB fallbacks")
    for p, r in zip(paths, results):
        log.debug(f"{p}: mse={r.mse:.3g} certified={r.certified}",
                  "\n\tRotation:\n", r.R, "\n\tTranslation: ", r.t)
    if cfg.io.output:
        _write_serve_result(cfg.io.output, paths, results, elapsed)
        log.info(f"Results written to {cfg.io.output}")
    return 0 if n_cert == len(results) else 2


def _write_serve_result(path: str, paths, results, elapsed: float) -> None:
    """The serving results as TOML (the JAX package's schema): a [serve]
    summary, then one [pair.i] section per cloud."""
    n_cert = sum(r.certified for r in results)
    n_fb = sum(r.fallback_used for r in results)
    with open(path, "w") as f:
        f.write(f"[serve]\npairs = {len(results)}\n"
                f"elapsed_seconds = {elapsed:.4f}\n"
                f"certified = {n_cert}\nfallbacks = {n_fb}\n")
        for i, (p, r) in enumerate(zip(paths, results)):
            rows = ",\n  ".join(
                "[" + ", ".join(f"{v:.9g}" for v in row) + "]"
                for row in np.asarray(r.R, np.float64))
            tv = ", ".join(f"{v:.9g}" for v in np.asarray(r.t, np.float64))
            f.write(f"\n[pair.{i}]\nsource = {p!r}\n"
                    f"mse = {r.mse:.9g}\n"
                    f"certified = {'true' if r.certified else 'false'}\n"
                    f"fallback = {'true' if r.fallback_used else 'false'}\n"
                    f"translation = [{tv}]\n"
                    f"rotation = [\n  {rows},\n]\n")


def _write_result(path: str, R, t, model: GoICP, elapsed: float) -> None:
    """Write the registration result as TOML (the JAX package's schema,
    emitted by hand — values only, flat)."""
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64)
    rows = ",\n  ".join(
        "[" + ", ".join(f"{v:.9g}" for v in row) + "]" for row in R)
    body = (
        "[result]\n"
        f"sse = {model.best_sse:.9g}\n"
        f"mse = {model.mse:.9g}\n"
        f"elapsed_seconds = {elapsed:.4f}\n"
        f"translation = [{', '.join(f'{v:.9g}' for v in t)}]\n"
        f"rotation = [\n  {rows},\n]\n"
        "\n[stats]\n"
        f"translation_nodes = {model.stats.translation_nodes}\n"
        f"rotation_children = {model.stats.rotation_children}\n"
        f"icp_runs = {model.stats.icp_runs}\n"
        f"outer_steps = {model.stats.outer_steps}\n"
        f"cubes_per_second = {model.stats.cubes_per_second:.2f}\n"
    )
    with open(path, "w") as f:
        f.write(body)


if __name__ == "__main__":
    sys.exit(run())
