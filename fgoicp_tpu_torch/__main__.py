"""CLI entry: `python -m fgoicp_tpu_torch -c <config.toml> [-v] [--seed N]
[--mesh-cubes N] [--mesh-points N] [--resume] [--profile DIR]
[--debug-nans] [--debug-checks] [--serve GLOB] [--device cuda|cpu]`.

Flag surface of the JAX package's CLI (and the reference app,
src/main.cpp:8-58): required -c/--config TOML path, -v/--verbose debug
logging, --seed for deterministic subsampling, --mesh-cubes /
--mesh-points for a device mesh (parallel/sharding.py), --resume from
engine.checkpoint_path, --profile DIR for a torch.profiler trace of the
registration (the JAX CLI's jax.profiler trace), --debug-nans to fail with
FloatingPointError on the first NaN in the compute path (utils/debug.py,
the counterpart of jax_debug_nans), --debug-checks for the search-state
sanitizer, --serve for the batched serving mode, plus --device (default
cuda; `cuda` without a card raises).  Writes the [io] output result TOML
and the [io] visualization PLY when set.

--profile traces `model.run()` (under --serve, `register` of the batch)
with the CPU activity, and the CUDA one on a card, and writes a Chrome
trace to DIR/trace_rank<R>.json, R the process's rank (0 without a mesh):
under a mesh each rank writes its own.  It turns on the program's ranges
(utils/trace.py), so the trace shows the request, its spans ("fgoicp.icp",
"fgoicp.construct", ...) and its host reads ("fgoicp.read") over the
kernels.  -v logs the finished request's record after the registration:
its span seconds, host reads and host wait, counts and kernel launches.

A mesh of more than one rank runs one process per rank.  Under torchrun
(WORLD_SIZE set) each process is a rank; otherwise this command starts the
ranks itself (torch.multiprocessing, spawn) on a free localhost port and
returns the first nonzero exit code of a rank, else 0.  Only rank 0 logs
(errors excepted) and writes the output files.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np

from . import __version__
from .config import Config
from .io import load_cloud, write_ply
from .models.goicp import GoICP
from .utils import debug
from .utils import logging as log
from .utils import trace


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
    p.add_argument("--mesh-cubes", type=int, default=None,
                   help="Override engine.mesh_cubes (ranks on the "
                        "rotation-cube axis)")
    p.add_argument("--mesh-points", type=int, default=None,
                   help="Override engine.mesh_points (ranks sharding the "
                        "source points)")
    p.add_argument("--resume", action="store_true",
                   help="Resume from engine.checkpoint_path if it exists")
    p.add_argument("--profile", metavar="DIR", default="",
                   help="Write a torch.profiler Chrome trace of the "
                        "registration to DIR/trace_rank<R>.json (view with "
                        "chrome://tracing or Perfetto)")
    p.add_argument("--debug-nans", action="store_true",
                   help="Fail fast with FloatingPointError on any NaN in "
                        "the compute path (kernel inputs and outputs, ICP "
                        "steps, Procrustes, bound evaluation): the "
                        "counterpart of jax_debug_nans")
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
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    with debug.nan_checks(args.debug_nans or debug.nan_checks_enabled()):
        return _run(args, argv)


def _profiled(args):
    """torch.profiler over the block when --profile is set, writing its
    Chrome trace to DIR/trace_rank<R>.json on the way out."""
    if not args.profile:
        return contextlib.nullcontext()
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(args.device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    path = os.path.join(args.profile,
                        f"trace_rank{int(os.environ.get('RANK', 0))}.json")

    @contextlib.contextmanager
    def traced():
        os.makedirs(args.profile, exist_ok=True)
        ranges = trace.enabled()
        trace.enable()
        try:
            with profile(activities=activities) as prof:
                yield
        finally:
            trace.enable(ranges)
        prof.export_chrome_trace(path)
        log.info(f"Profile trace written to {path}")
    return traced()


def _run(args, argv) -> int:
    log.set_verbose(args.verbose)
    cfg = Config.from_toml(args.config)
    if args.debug_checks:
        cfg.engine.debug_checks = True
    if args.seed is not None:
        cfg.engine.seed = args.seed
    if args.mesh_cubes is not None:
        cfg.engine.mesh_cubes = args.mesh_cubes
    if args.mesh_points is not None:
        cfg.engine.mesh_points = args.mesh_points
    ranks = cfg.engine.mesh_cubes * cfg.engine.mesh_points
    if ranks > 1 and "WORLD_SIZE" not in os.environ:
        # One spawned process per rank, joined over env:// on a free port.
        from .parallel.sharding import spawn_ranks
        return spawn_ranks("fgoicp_tpu_torch.__main__:run", argv, ranks)
    writer = int(os.environ.get("RANK", 0)) == 0
    log.set_quiet(not writer)

    pct = load_cloud(cfg.io.target, cfg.params.target_subsample,
                     seed=cfg.engine.seed)
    log.info(f"Target point cloud ({len(pct)}) loaded from {cfg.io.target}")
    if args.serve:
        return _run_serve(cfg, args, pct, writer)
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
    with _profiled(args):
        t0 = trace.now()
        R, t = model.run()
        elapsed = trace.now() - t0
    log.info(f"Registration completed in {elapsed:.3f}s "
             f"({model.stats.cubes_per_second:.0f} cubes/s)")
    log.debug(trace.summary(trace.requests()[-1]))

    if cfg.io.output and writer:
        _write_result(cfg.io.output, R, t, model, elapsed)
        log.info(f"Result written to {cfg.io.output}")
    if cfg.io.visualization and writer:
        aligned = np.asarray(pcs, np.float32) @ np.asarray(R, np.float32).T \
            + np.asarray(t, np.float32)
        write_ply(cfg.io.visualization, aligned)
        log.info(f"Transformed source written to {cfg.io.visualization}")
    return 0


def _run_serve(cfg: Config, args, pct, writer: bool = True) -> int:
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
    with _profiled(args):
        t0 = trace.now()
        results = srv.register(batch)
        elapsed = trace.now() - t0
    n_cert = sum(r.certified for r in results)
    n_fb = sum(r.fallback_used for r in results)
    log.info(f"Registered {len(results)} pairs in {elapsed:.3f}s "
             f"({len(results) / elapsed:.2f} pairs/s): {n_cert} certified, "
             f"{n_fb} BnB fallbacks")
    log.debug(trace.summary(trace.requests()[-1]))
    for p, r in zip(paths, results):
        log.debug(f"{p}: mse={r.mse:.3g} certified={r.certified}",
                  "\n\tRotation:\n", r.R, "\n\tTranslation: ", r.t)
    if cfg.io.output and writer:
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
