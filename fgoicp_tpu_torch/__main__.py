"""CLI entry: `python -m fgoicp_tpu_torch -c <config.toml> [-v] [--seed N]
[--device cuda|cpu]`.

Flag surface of the JAX package's CLI (and the reference app,
src/main.cpp:8-58) for the ported main path: required -c/--config TOML
path, -v/--verbose debug logging, --seed for deterministic subsampling,
plus --device (default cuda; `cuda` without a card raises).  Writes the
[io] output result TOML and the [io] visualization PLY when set.  Serving,
resume, profiling and mesh flags are not offered yet.
"""

from __future__ import annotations

import argparse
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
    p.add_argument("--device", default="cuda",
                   help="Torch device to run on (default: cuda)")
    p.add_argument("--version", action="version",
                   version=f"%(prog)s {__version__}")
    return p


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)
    log.set_verbose(args.verbose)
    cfg = Config.from_toml(args.config)
    if args.seed is not None:
        cfg.engine.seed = args.seed

    pct = load_cloud(cfg.io.target, cfg.params.target_subsample,
                     seed=cfg.engine.seed)
    log.info(f"Target point cloud ({len(pct)}) loaded from {cfg.io.target}")
    pcs = load_cloud(cfg.io.source, cfg.params.source_subsample,
                     seed=cfg.engine.seed + 1)
    log.info(f"Source point cloud ({len(pcs)}) loaded from {cfg.io.source}")

    model = GoICP(
        pct, pcs, lut_resolution=cfg.params.lut_resolution,
        mse_threshold=cfg.params.mse_threshold, engine=cfg.engine,
        trim_fraction=(cfg.params.trim_fraction if cfg.params.trim else 0.0),
        device=args.device)
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
