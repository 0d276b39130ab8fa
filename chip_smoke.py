#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`fgoicp_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--profile]

Phases, each failing the run (nonzero exit) on its first failed check:
  1. print the GPU's name and power limit (nvidia-smi) and the torch / CUDA
     versions; build the CUDA kernels from `fgoicp_tpu_torch/csrc` and print
     the build seconds;
  2. the kernel gate, `fgoicp_tpu_torch/scripts/kernel_check.py`'s full
     grid (`run_check("full")`): every CUDA kernel against its plain torch
     version at synthetic main-path, mesh and edge shapes, FPS with its us
     a step and latency bound, the ICP iteration's kernels at every step
     until their lanes stop; the first row that does not pass fails the
     run;
  3. run the default main path, `register(Config)` on cuda, on a seeded
     asymmetric 18,000 / 3,000-point pair with a known pose: it must
     certify (last_certified_gap <= sse_threshold), recover the pose
     (R max-abs error < 5e-3, t error < 5e-3 x span) and launch the FPS
     and ICP kernels; cold, then warm;
  4. the same with icp_multi_start = false, the search-only form of the
     path, which must also bound translation nodes and launch the NN,
     lane, FPS and ICP kernels;
  5. trimmed registration (trim = true, trim_fraction = 0.3) on a seeded
     partial-overlap pair (20,000 target / 10,000 source points, 22.5 % of
     the source outside the target's part of the curve), default and
     search-only; both must certify, recover the pose and launch the FPS
     kernel (the default also the ICP kernels), and the search-only run
     must launch the trimmed lane kernel;
  6. the grouped inner scheduler (frontier_mode = "grouped", search-only) on
     the 18,000 / 3,000 pair; it must certify, recover the pose and launch
     the grid kernel;
  7. the LUT backend, search-only, on the 18,000 / 3,000 pair as the JAX
     bench's bunny_lut_res0.002 line runs it: GoICP(..., lut_resolution=
     0.002, bound_backend="lut"), cold then warm; each run must certify,
     recover the pose, build its field by the EDT, launch `minplus_1d`
     exactly 3 times and the NN kernels, and no proxy lane kernel.  A
     standalone build of the same field reports its dims, seconds and peak
     memory against check_memory_budget's estimate;
  8. the EDT field at the real bunny field's size at res 0.002 (960 x 946 x
     741 nodes, from a seeded synthetic cloud), in bfloat16 and float32:
     build seconds and peak memory within check_memory_budget's estimate,
     and values at 4,096 nodes within the builder's slack of exact
     distances;
  9. serving through RegistrationService on cuda, on a synthetic stand-in
     for the JAX bench's serving lines (the skull scan is not in the
     repository): a seeded 98,359-point curve cloud (noise 0.0025), a
     6,000-point target
     drawn from it; 9a, 32 sources of 8,000 points at uniform random poses,
     mse_threshold 1e-3, cold then warm: every pair certified and its pose
     recovered (R < 5e-3, t < 5e-3 x span); 9b, 8 ragged half-space partial
     views (3,000 to 6,000 points) at VIEW_MSE, checked first to lie between
     the views' true-pose floor and their wrong-basin seeding mse, cold then
     warm: at least one BnB fallback, which launched fused_bounds_lanes, and
     every pair certified and recovered (R < 5e-3, t < 2e-3 x span).
     The cold runs of phases 3 to 7 and 9 run under kernel_check's
     recorder (`Recorder`; phase 8 builds its fields outside them): then
     every distinct shape at which they launched nn_argmin, nn_min, the
     three bound kernels and minplus_1d (the main paths, trimmed, grouped,
     the LUT field's three EDT passes, the serving batch's seeding,
     rescore, polish and covering radius, a fallback's lane kernel) is
     held against its plain version (`Recorder.check`), and each of the
     six must be held at some shape;
 10. the device outer loop (outer_mode = "device"): 10a search-only and 10b
     trimmed search-only through register(Config), cold then warm, each
     certified at the known pose, launching the NN kernels and its bound
     kernel, with best_sse within sse_threshold of phase 4's / 5's host
     loop, walls, counters and the runs' host reads side by side;
     10c both checkpoint kinds: a search-only run with checkpoint_every = 1
     into build/chip_smoke/ killed after its second checkpoint (the host
     loop's first when it takes one step) and resumed by a fresh GoICP with
     debug_checks = True, certified at the known pose and phase 4's
     optimum; 10d an overflowing frontier (so3_capacity = 8 x
     rotation_batch, OVERFLOW_ENGINE): the device gap must end open, the
     host loop re-certify and close it within sse_threshold of phase 4's
     optimum; then the same engine's many-step search in both outer modes;
 11. the multi-host outer BnB (`fgoicp_tpu_torch.parallel`) on 10d's
     many-step engine (so3_capacity 16384), against its single-host runs:
     11a 4 thread hosts in host mode (sync every step, steal 8) and 11b 2
     thread hosts in device mode (sync every 4, steal 4), each host a thread
     under its own CUDA stream over ThreadCommunicator, each run twice,
     and 11a once more at a 0.1 ms interpreter switch interval; 11c 2
     processes on this card (this script in worker mode), joined over gloo
     by initialize() on a free localhost port, 11a's settings, each run
     twice, beside the same search as 2 thread hosts.  Every rank must
     certify at one best_sse within sse_threshold of the single host's,
     pass check_result's pose gate on its certified pose's basin (one
     converged ICP from it: the engine's ten-iteration polish stops short
     of the known pose), and launch fused_bounds_lanes and nn_argmin;
     verify_agreement (11a, 11b), conservation of stolen nodes, and in 11c
     equal gather digests on both ranks.  Walls, CPU seconds, counters and
     nodes per second are printed per rank and beside the single host's;
     launch counts are sums over all hosts;
 12. the device mesh (`fgoicp_tpu_torch/parallel/sharding.py`, `bnb.py`),
     each sub-phase run once as gloo processes sharing this card (this
     script in `--mesh-worker` mode; the ranks join through the user entry
     points over env://, as under torchrun; each sub-phase runs cold, then
     warm, in its processes): 12a a 2 x 1 mesh, search-only
     on the smoke pair; 12b 1 x 2, search-only, the grouped scheduler
     search-only, then trimmed search-only on the 20k / 10k pair; 12c 2 x 2,
     device outer mode; 12d 9a's 32-pair batch served on 2 x 1.  Every rank
     must certify at the known pose, every rank's digest be equal, best_sse
     lie within sse_threshold of the single device's (phases 4, 6, 5, 10a;
     9a's pairs), and the path's kernels launch (point-sharded trimming
     must not launch the trimmed lane kernel); rank 0 of each sub-phase
     records its cold runs (kernel_check's `Recorder`) and holds every
     launch shape against the plain version; nn_argmin, nn_min,
     fused_bounds_lanes and fused_bounds must each be held at some shape.
     Walls, nodes, collectives, gathered bytes, host copies and per-rank
     launches are printed beside the card's name and power limit;
 13. hosts on meshes (`parallel/distributed.py::make_host_mesh`): 2 hosts,
     each on its own mesh of gloo processes sharing this card (this script
     in `--hostmesh-worker` mode, 4 processes a sub-phase), phase 11's
     many-step engine on the smoke pair, cold then warm: 13a 2 x (1 x 2)
     host mode, 13b 2 x (2 x 1) device mode, 13c 2 x (2 x 1) with the LUT
     backend at lut_resolution 0.002 (a field a rank).  Every rank must
     certify (the pose gate on its certified pose's basin) within
     sse_threshold of phase 11's single host, all ranks gather the same
     matrices, a host's mesh ranks end in equal states, donated == stolen
     counted once a host, and the path's kernels launch (13c: minplus_1d 3
     times a rank, no proxy lane kernel); rank 0 of each sub-phase holds
     its cold run's launch shapes against the plain versions (`Recorder`);
 14. the rest of the slice: search-only and device search-only with
     pool_update = "merge" (certified, best_sse within sse_threshold of
     phases 4 and 10a, nodes and steps beside sort's); the CLI on the smoke
     pair three times at once, plain, --debug-nans (the same result TOML)
     and --profile DIR (a Chrome trace naming nn_kernel and
     bounds_lanes_kernel);
 15. the experiment tools of fgoicp_tpu_torch/scripts, called as functions
     (`tools_phase`): 15a step_decomp at its defaults (the pieces sum to no
     more than a step); 15b micro_step at its defaults, or, where its drain
     guard refuses them, at the --steps the refusal names (the bare kernel
     no more than a pooled step); 15c mxu_experiment (nn_min at 1 M and 4 M
     x 4,096, the norm-expansion errors printed); 15d minplus_experiment
     (the float64 gate, the kernel bit-equal at [262,144 x 1,024], the EDT
     fields equal); 15e hard_pairs --pair synth in host and device outer
     mode (certified, the seeding's gap open, rotation_children > 0, more
     translation nodes than phase 5's trimmed search-only; the certified
     pose in the known pose's basin); 15f serving_experiment ragged and
     fallback (every pair certified; a fallback that launches
     fused_bounds_lanes_trimmed).
     Every launch shape the tools give a kernel is held against its plain
     version afterwards (`Recorder`).
Each path's launches are the deltas of the wrappers' counters over it
(`utils/trace.py::launch_counts`); the phase lines also give the NN
kernels' launches per (M, T).  With
--profile, one warm run each of trimmed search-only, search-only, grouped
search-only, device search-only and a 9a batch is then traced with
torch.profiler (device time
by kernel, launch count, busy share, and the device time and launches of
the phase's bound kernel, for serving the NN kernel).  Every time and rate
of phase 9 is printed beside the card's name and power limit.

Earlier lines report walls, node counts, launch counts and a JSON line of
every kernel row (the grid's and the recorded launches'); the last line
is {"ok": true, "device": {...}}.  Needs a CUDA GPU (exits nonzero without
one) and imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

from fgoicp_tpu_torch.scripts import kernel_check as kc
from fgoicp_tpu_torch.scripts import workloads

ROOT = pathlib.Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
# The reference's bunny distance-field resolution (configs/bunny.toml), at
# which the JAX bench runs the LUT backend (bench.py bunny_lut_res0.002).
LUT_RESOLUTION = 0.002
# The real bunny field's dims at that resolution (BASELINE.md), which
# phase 8 reproduces with a synthetic cloud.
BUNNY_FIELD_DIMS = (960, 946, 741)
# Phase 9b's mse threshold, by the JAX bench's rule (bench.py:297-311):
# above every partial view's mse at its true pose (the target subsample's
# NN floor) and below the mse of every view that seeding leaves in a wrong
# basin, so that a certificate is a true pose and the wrong-basin views
# must take the fallback.  Phase 9b prints both and checks the rule.
# Measured (NVIDIA H100 80GB HBM3, 700 W): floors 4.68e-6 to 1.43e-5, two
# views seeded into wrong basins at 7.96e-5 and 1.03e-2; VIEW_MSE is the
# geometric mean of 1.43e-5 and 7.96e-5.
VIEW_MSE = 4.3e-5
def say(msg):
    print(msg, flush=True)


def snapshot():
    """The kernel wrappers' launch counts and the NN wrappers' launches per
    (M, T), now; `since` reads them back as deltas."""
    from fgoicp_tpu_torch.ops import cuda_nn
    from fgoicp_tpu_torch.utils import trace
    return trace.launch_counts(), {
        fn.__name__: collections.Counter(fn.shapes)
        for fn in (cuda_nn.nn_argmin, cuda_nn.nn_min)}


def since(snap):
    """(launches by kernel, NN launches by M x T) since `snap`."""
    launches, shapes = snapshot()
    return ({k: v - snap[0][k] for k, v in launches.items()},
            {k: {f"{m}x{t}": n for (m, t), n in sorted((c - snap[1][k])
                                                        .items())}
             for k, c in shapes.items()})


def held(label, rows, smi_line, need=()):
    """Print kernel_check rows of recorded launches and how many launch
    shapes each kernel was held at; fail on the first row that does not
    pass, and when a kernel of `need` was held at no shape."""
    for r in rows:
        say(f"{label} ({smi_line}): {kc.describe(r)}")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"{label}: {kc.describe(bad[0])}")
    count = collections.Counter(r["kernel"] for r in rows)
    missing = [k for k in need if not count[k]]
    if missing:
        raise AssertionError(f"{label}: kernels {missing} held at no shape "
                             f"against their plain versions")
    say(f"{label} ({smi_line}): launch shapes held against the plain "
        f"versions: {dict(count)}")


def write_config(name, pct_np, pcs_np, params):
    from fgoicp_tpu_torch import Config, load_cloud, write_ply
    tgt, src = WORK / f"{name}_target.ply", WORK / f"{name}_source.ply"
    toml = WORK / f"{name}.toml"
    write_ply(str(tgt), pct_np)
    write_ply(str(src), pcs_np)
    toml.write_text(f'[io]\ntarget = "{tgt}"\nsource = "{src}"\n\n'
                    f'[params]\n{params}\n\n[engine]\nseed = 0\n')
    cfg = Config.from_toml(str(toml))
    # The reference clamps source_subsample to <= 0.5; the clouds are loaded
    # whole and handed to register so the source keeps all its points.
    return cfg, load_cloud(cfg.io.target), load_cloud(cfg.io.source)


def pose_errors(R, t, truth):
    """(R max-abs error, t max-abs error / span) against the known pose."""
    _, _, R_true, t_true, span = truth
    return (float(np.abs(np.asarray(R) - R_true).max()),
            float(np.abs(np.asarray(t) - t_true).max() / span))


def check_result(label, model, R, t, r_err, t_err):
    """The gate of every registration phase: a finite pose of the right
    shape, a certificate (gap <= sse_threshold) and the known pose."""
    R, t = np.asarray(R), np.asarray(t)
    if R.shape != (3, 3) or t.shape != (3,) or not (
            np.all(np.isfinite(R)) and np.all(np.isfinite(t))):
        raise AssertionError(f"{label}: non-finite or misshapen pose")
    if not model.last_certified_gap <= model.sse_threshold:
        raise AssertionError(f"{label}: not certified")
    if not (r_err < 5e-3 and t_err < 5e-3):
        raise AssertionError(f"{label}: pose not recovered")


def timed_build(torch, points, bounds, builder="auto", dtype=None):
    """One distance-field build at LUT_RESOLUTION on the card: the field,
    its synchronized seconds, the peak bytes allocated above what was
    allocated before it, and check_memory_budget's estimate of that peak."""
    from fgoicp_tpu_torch.ops import distance_field as df
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.time()
    field = df.build(points, bounds, LUT_RESOLUTION, builder=builder,
                     dtype=dtype)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    peak = torch.cuda.max_memory_allocated() - base
    estimate = df.check_memory_budget(field.dims, dtype, field.builder,
                                      device=points.device)
    if peak > estimate:
        raise AssertionError(
            f"field build {field.dims} {dtype}: peak {peak} B above "
            f"check_memory_budget's {estimate} B")
    return field, seconds, peak, estimate


def lut_phase(torch, dev, pair, rec):
    """Phase 7: LUT search-only on the smoke pair, as the JAX bench's
    bunny_lut_res0.002 line runs it (lut_resolution 0.002, bfloat16 field,
    multi-start off), cold then warm through GoICP(..., bound_backend="lut")
    (no TOML key selects the backend).  A standalone build of the same field
    first gives its dims, build seconds and peak memory."""
    from fgoicp_tpu_torch import EngineConfig, GoICP
    from fgoicp_tpu_torch.ops import geometry as geo

    norm = geo.Normalization(torch.from_numpy(pair[0]).to(dev),
                             torch.from_numpy(pair[1]).to(dev))
    field, seconds, peak, estimate = timed_build(
        torch, norm.pct, norm.target_bounds, dtype=torch.bfloat16)
    say(f"LUT search-only field (standalone build of the engine's field): "
        f"dims {field.dims}, builder {field.builder}, bfloat16, build "
        f"{seconds!r} s, peak {peak} B <= check_memory_budget {estimate} B")
    if field.builder != "edt":
        raise AssertionError(f"LUT field built by {field.builder}, not edt")
    del field, norm
    for run in ("cold", "warm"):
        snap = snapshot()
        t_run = time.time()
        with (rec.record("7 LUT search-only") if run == "cold"
              else contextlib.nullcontext()):
            model = GoICP(pair[0], pair[1], lut_resolution=LUT_RESOLUTION,
                          mse_threshold=1e-3,
                          engine=EngineConfig(icp_multi_start=False, seed=0),
                          bound_backend="lut", device=dev)
            R, t = model.run()
        torch.cuda.synchronize()
        wall = time.time() - t_run
        launched, nn_shapes = since(snap)
        r_err, t_err = pose_errors(R, t, pair)
        s = model.stats
        say(f"LUT search-only {run}: wall {wall!r} s (GoICP() + run()), run "
            f"{s.wall_seconds!r} s, field {model.backend.field.dims} by "
            f"{model.backend.field.builder}, best_sse {model.best_sse!r}, gap "
            f"{model.last_certified_gap!r} <= {model.sse_threshold!r}, R err "
            f"{r_err!r}, t err/span {t_err!r}, translation_nodes "
            f"{s.translation_nodes}, rotation_children {s.rotation_children}, "
            f"outer_steps {s.outer_steps}, inner_loop_steps "
            f"{s.inner_loop_steps}, icp_runs {s.icp_runs}, launches "
            f"{launched}, NN launches by shape {nn_shapes}")
        check_result(f"LUT search-only {run}", model, R, t, r_err, t_err)
        if model.backend.field.builder != "edt":
            raise AssertionError("LUT search-only: field not built by edt")
        if s.translation_nodes <= 0:
            raise AssertionError("LUT search-only: no translation node bounded")
        if launched["minplus_1d"] != 3:
            raise AssertionError(f"LUT search-only {run}: minplus_1d launched "
                                 f"{launched['minplus_1d']} times, not 3")
        if launched["nn_argmin"] <= 0 or launched["nn_min"] <= 0:
            raise AssertionError(f"LUT search-only {run}: NN kernels never "
                                 f"launched")
        if launched["fused_bounds_lanes"] or \
                launched["fused_bounds_lanes_trimmed"]:
            raise AssertionError(f"LUT search-only {run}: a proxy lane "
                                 f"kernel ran on the LUT path")


def bunny_field_phase(torch, dev):
    """Phase 8: the EDT field at the reference's operating-point size.  A
    seeded 18,000-point curve scaled so that its box gives the real bunny
    field's dims at res 0.002 (960 x 946 x 741 nodes, 0.67 G cells); built
    with bfloat16 and with float32 storage, each within check_memory_budget's
    estimate; the float32 values at 4,096 seeded grid nodes within
    field.slack (sqrt(3/2) * res) + 1e-5 of the exact nn_min distances."""
    from fgoicp_tpu_torch.ops import cuda_minplus, cuda_nn

    rng = np.random.default_rng(8)
    pts = workloads.curve(rng, rng.uniform(0.0, 4.5, size=18000))
    # Ranges half a cell short of (dims - 1) * res: grid_dims' ceil then
    # lands on the dims whatever the float rounding of the ranges.
    box = (np.asarray(BUNNY_FIELD_DIMS) - 1.5) * LUT_RESOLUTION
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    pts = (((pts - lo) / (hi - lo) - 0.5) * box).astype(np.float32)
    points = torch.from_numpy(pts).to(dev)
    bounds = np.stack([pts.min(axis=0), pts.max(axis=0)], axis=-1)
    launched = cuda_minplus.minplus_1d.launches
    for dtype in (torch.bfloat16, torch.float32):
        field, seconds, peak, estimate = timed_build(
            torch, points, bounds, builder="edt", dtype=dtype)
        say(f"bunny-size field: dims {field.dims} "
            f"({int(np.prod(field.dims))} cells), {dtype}, EDT build "
            f"{seconds!r} s, peak {peak} B <= check_memory_budget "
            f"{estimate} B")
        if dtype == torch.float32:
            idx = torch.from_numpy(
                rng.integers(0, field.dims, size=(4096, 3))).to(dev)
            res = torch.tensor(LUT_RESOLUTION, device=dev)
            pos = field.origin + idx.to(torch.float32) * res
            exact = torch.sqrt(cuda_nn.nn_min(pos.contiguous(), points))
            vals = field.values[idx[:, 0], idx[:, 1], idx[:, 2]]
            err = float((vals - exact).abs().max())
            limit = float(field.slack) + 1e-5
            say(f"bunny-size field: 4096 nodes, max |EDT - exact| {err!r} "
                f"<= slack + 1e-5 = {limit!r}")
            if not err <= limit:
                raise AssertionError(f"bunny-size field: EDT error {err} "
                                     f"beyond the slack {limit}")
        del field
    say(f"bunny-size field: {cuda_minplus.minplus_1d.launches - launched} "
        f"minplus_1d launches over both builds")


def serving_checks(label, results, truth, span, t_limit):
    """Phase 9's gate: every pair a finite pose, certified, and its known
    pose recovered (R max-abs < 5e-3, t < t_limit x span).  Returns the
    largest R and t / span errors."""
    r_max = t_max = 0.0
    for i, (r, (R_true, t_true)) in enumerate(zip(results, truth)):
        if not (np.all(np.isfinite(r.R)) and np.all(np.isfinite(r.t))
                and np.isfinite(r.sse)):
            raise AssertionError(f"{label}: pair {i} non-finite")
        if not r.certified:
            raise AssertionError(f"{label}: pair {i} not certified (mse "
                                 f"{r.mse!r})")
        r_err = float(np.abs(np.asarray(r.R) - R_true).max())
        t_err = float(np.abs(np.asarray(r.t) - t_true).max() / span)
        if not (r_err < 5e-3 and t_err < t_limit):
            raise AssertionError(f"{label}: pair {i} pose not recovered (R "
                                 f"err {r_err!r}, t err/span {t_err!r})")
        r_max, t_max = max(r_max, r_err), max(t_max, t_err)
    return r_max, t_max


def serving_phase(torch, dev, data, rec, smi_line):
    """Phase 9: the serving mode through RegistrationService on cuda.

    9a, throughput (stands in for bench.py's serving_throughput_32pairs):
    the 32 x 8,000-point batch against the 6,000-point target, default
    engine, mse_threshold 1e-3; the service is built, then `register` runs
    cold and warm.  Every pair must certify and recover its pose (R < 5e-3,
    t < 5e-3 x span); the run must launch both NN kernels, and
    `fused_bounds_lanes` when a pair fell back.

    9b, fallback-heavy (stands in for serving_fallback_heavy_8pairs): the 8
    ragged partial views, the weighted path, at VIEW_MSE.  First each
    view's mse at its true pose (its subsample NN floor) and, by one seeding
    pass with fallback=False, at its seeding pose; VIEW_MSE must lie above
    every floor and below the seeding mse of every view seeded into a wrong
    basin (R error >= 0.05).  Then cold and warm: at least one fallback, which launched
    `fused_bounds_lanes`, and every pair certified and recovered (R < 5e-3,
    t < 2e-3 x span)."""
    from fgoicp_tpu_torch.models.serving import RegistrationService
    from fgoicp_tpu_torch.ops import cuda_nn

    pct, span = data["pct"], data["span"]

    def drive(label, make, batch, truth, t_limit, need_fallback=False):
        """Build the service, then register cold and warm; returns it."""
        srv = None
        for run in ("cold", "warm"):
            snap = snapshot()
            t_run = time.time()
            with (rec.record(label) if run == "cold"
                  else contextlib.nullcontext()):
                if srv is None:
                    srv = make()
                    torch.cuda.synchronize()
                    setup = time.time() - t_run
                before = dict(vars(srv.stats))
                results = srv.register(batch)
            torch.cuda.synchronize()
            wall = time.time() - t_run
            launched, nn_shapes = since(snap)
            st = {k: v - before[k] for k, v in vars(srv.stats).items()}
            b = len(batch)
            r_max, t_max = serving_checks(f"{label} {run}", results, truth,
                                          span, t_limit)
            say(f"{label} {run} ({smi_line}): wall {wall!r} s for {b} pairs "
                f"({b / wall!r} pairs/s"
                + (f"; RegistrationService() {setup!r} s of it" if run ==
                   "cold" else "") + f"), seeding {st['seed_seconds']!r} s, "
                f"fallbacks {st['fallback_seconds']!r} s, "
                f"certified_by_seeding {st['certified_by_seeding']}, "
                f"fallbacks {st['fallbacks']}, max R err {r_max!r}, max t "
                f"err/span {t_max!r}, launches {launched}, NN launches by "
                f"shape {nn_shapes}")
            missing = [k for k in ("nn_argmin", "nn_min") if launched[k] <= 0]
            if st["fallbacks"] and launched["fused_bounds_lanes"] <= 0:
                missing.append("fused_bounds_lanes")
            if missing:
                raise AssertionError(f"{label} {run}: kernels {missing} never "
                                     f"launched")
            if need_fallback and st["fallbacks"] <= 0:
                raise AssertionError(f"{label} {run}: no pair fell back to "
                                     f"the BnB")
        return srv

    srv_a = drive("serving 9a", lambda: RegistrationService(
        pct, mse_threshold=1e-3, device=dev), data["sources"], data["truth"],
        5e-3)

    # 9b: the threshold rule, then the fallback-heavy batch.
    views, vtruth = data["views"], data["view_truth"]
    pct_t = torch.as_tensor(pct, device=dev)
    floors = []
    for v, (R, t) in zip(views, vtruth):
        world = torch.as_tensor(v @ R.T + t, device=dev)
        centred = v - v.mean(axis=0)
        scale = 1.0 / float(np.abs(centred).max())
        floors.append(float(cuda_nn.nn_min(world, pct_t).sum()) * scale ** 2
                      / len(v))
    probe = RegistrationService(pct, mse_threshold=VIEW_MSE, device=dev)
    seeded = probe.register(views, fallback=False)
    # A wrong basin: a rotation error of 0.05 or more (a pose in the right
    # basin that is merely not polished to 5e-3 sits at the floor).
    wrong = [r.mse for r, (R, _) in zip(seeded, vtruth)
             if float(np.abs(np.asarray(r.R) - R).max()) >= 5e-2]
    say(f"serving 9b threshold rule: mse at the true poses (subsample NN "
        f"floor) {floors}, seeding mse {[r.mse for r in seeded]}, of them in "
        f"a wrong basin {wrong}; VIEW_MSE {VIEW_MSE!r}")
    if not (max(floors) < VIEW_MSE and all(m > VIEW_MSE for m in wrong)):
        raise AssertionError("serving 9b: VIEW_MSE does not separate the true "
                             "poses' floor from the wrong basins")
    del probe, pct_t
    drive("serving 9b", lambda: RegistrationService(
        pct, mse_threshold=VIEW_MSE, device=dev), views, vtruth, 2e-3,
        need_fallback=True)
    return srv_a


def compare_modes(label, device_runs, host_runs, smi_line):
    """Phase 10a/b's comparison with the host loop's phase on the same pair:
    the device loop's best_sse must lie within sse_threshold of the host
    loop's; walls, counters and the runs' host reads (the request's
    `utils/trace` record) side by side."""
    for run in ("cold", "warm"):
        d, h = device_runs[run]["model"], host_runs[run]["model"]
        if not abs(d.best_sse - h.best_sse) <= d.sse_threshold:
            raise AssertionError(
                f"{label} {run}: best_sse {d.best_sse!r} not within "
                f"{d.sse_threshold!r} of the host loop's {h.best_sse!r}")
    dw, hw = device_runs["warm"], host_runs["warm"]
    ds, hs = dw["model"].stats, hw["model"].stats
    say(f"{label} against the host loop ({smi_line}): warm wall "
        f"{dw['wall']!r} s vs {hw['wall']!r} s, cold "
        f"{device_runs['cold']['wall']!r} s vs {host_runs['cold']['wall']!r} "
        f"s; outer_steps {ds.outer_steps} vs {hs.outer_steps}, "
        f"rotation_children {ds.rotation_children} vs "
        f"{hs.rotation_children}, translation_nodes {ds.translation_nodes} "
        f"vs {hs.translation_nodes}, icp_runs {ds.icp_runs} vs "
        f"{hs.icp_runs}; host reads per run {dw['host_reads']} vs "
        f"{hw['host_reads']}; "
        f"best_sse {dw['model'].best_sse!r} vs {hw['model'].best_sse!r}")


def checkpoint_phase(torch, dev, pair, ref_sse, host_steps):
    """Phase 10c: checkpoints on the card.  A search-only run of the smoke
    pair with checkpoint_every = 1 into a file under build/ is killed right
    after its second checkpoint (device: the second one-step chunk; host:
    the second outer step, or the first when the host search takes one),
    then a fresh GoICP with debug_checks = True resumes it: the result must
    certify, recover the pose and reach ref_sse (the host search-only
    optimum) within sse_threshold."""
    from fgoicp_tpu_torch import EngineConfig, GoICP
    from fgoicp_tpu_torch.utils import checkpoint as ckpt

    for kind in ("device", "host"):
        path = WORK / f"checkpoint_{kind}.npz"
        path.unlink(missing_ok=True)
        saves = 2 if kind == "device" else min(2, host_steps)

        def make(**engine):
            return GoICP(pair[0], pair[1], mse_threshold=1e-3, device=dev,
                         engine=EngineConfig(
                             icp_multi_start=False, seed=0, outer_mode=kind,
                             checkpoint_path=str(path), checkpoint_every=1,
                             **engine))

        snap = snapshot()
        t_run = time.time()
        model = make()
        name = "_save_device_checkpoint" if kind == "device" \
            else "save_checkpoint"
        real, calls = getattr(model, name), []

        def dying_save(*args, real=real, calls=calls):
            real(*args)
            calls.append(1)
            if len(calls) == saves:
                raise RuntimeError("simulated kill")

        setattr(model, name, dying_save)
        try:
            model.run()
        except RuntimeError as err:
            if str(err) != "simulated kill":
                raise
        else:
            raise AssertionError(f"checkpoint {kind}: the run ended before "
                                 f"its checkpoint {saves}")
        killed = time.time() - t_run
        resumed = make(debug_checks=True)
        resumed.load_checkpoint(str(path))
        steps_at_resume = resumed.stats.outer_steps
        R, t = resumed.run()
        torch.cuda.synchronize()
        wall = time.time() - t_run
        launched = since(snap)[0]
        r_err, t_err = pose_errors(R, t, pair)
        s = resumed.stats
        say(f"checkpoint {kind} ({ckpt.peek_kind(str(path))}): killed after "
            f"checkpoint {saves} at {killed!r} s, resumed at outer step "
            f"{steps_at_resume} with debug_checks, wall {wall!r} s in all, "
            f"best_sse {resumed.best_sse!r} (host search-only "
            f"{ref_sse!r}), gap {resumed.last_certified_gap!r} <= "
            f"{resumed.sse_threshold!r}, R err {r_err!r}, t err/span "
            f"{t_err!r}, outer_steps {s.outer_steps}, translation_nodes "
            f"{s.translation_nodes}, icp_runs {s.icp_runs}, launches "
            f"{launched}")
        check_result(f"checkpoint {kind}", resumed, R, t, r_err, t_err)
        if not abs(resumed.best_sse - ref_sse) <= resumed.sse_threshold:
            raise AssertionError(f"checkpoint {kind}: resumed best_sse "
                                 f"{resumed.best_sse!r} not within "
                                 f"sse_threshold of {ref_sse!r}")
        path.unlink()


# Phase 10d's engine (beyond search-only and outer_mode "device"): with
# rotation_batch 16 and so3_capacity 128 the smoke pair's frontier keeps the
# optimum's subtree through every spill, and once any incumbent lies below
# sse_threshold (3.0) the gap closes whatever was dropped; on one H100 no
# variant of six (ICP width 1-16, 1-100 iterations, no child refines) left
# it open.  Two rotations a step and a 16-node frontier (8 *
# rotation_batch), with four ICP lanes of ten iterations on triggered
# children only, drop the optimum's subtree while the incumbent is still in
# a wrong basin: the device gap ends open.  The ten-iteration polish leaves
# the certified pose short of the 5e-3 pose gate, so this phase checks the
# certificate and the optimum, not the pose.
OVERFLOW_ENGINE = dict(rotation_batch=2, so3_capacity=16,
                       icp_refine_best=False, icp_width=4, icp_max_iter=10)


def overflow_phase(torch, dev, pair, ref_sse):
    """Phase 10d: so3_capacity = 8 * rotation_batch (OVERFLOW_ENGINE).  The
    frontier spills, the device gap must end open, the host loop must
    re-certify (shown by its seed_heap call after the device search), the
    final gap must close and best_sse must lie within sse_threshold of
    ref_sse (host search-only's).  Then the same engine with the default
    capacity, device and host loops, each run twice: the second runs' walls
    side by side, a search of many outer steps.  Returns the second runs'
    rank_summary by mode, phase 11's single-host references."""
    from fgoicp_tpu_torch import EngineConfig, GoICP
    from fgoicp_tpu_torch.utils import trace

    def make(**engine):
        return GoICP(pair[0], pair[1], mse_threshold=1e-3, device=dev,
                     engine=EngineConfig(icp_multi_start=False, seed=0,
                                         **dict(OVERFLOW_ENGINE, **engine)))

    snap = snapshot()
    t_run = time.time()
    model = make(outer_mode="device")
    device_gaps, device_steps = [], []
    real_seed = model.seed_heap

    def seed_heap():
        device_gaps.append(model.last_certified_gap)
        device_steps.append(model.stats.outer_steps)
        return real_seed()

    model.seed_heap = seed_heap
    R, t = model.run()
    torch.cuda.synchronize()
    wall = time.time() - t_run
    launched = since(snap)[0]
    r_err, t_err = pose_errors(R, t, pair)
    s = model.stats
    say(f"overflow ({OVERFLOW_ENGINE}): device gap {device_gaps!r} after "
        f"{device_steps} outer steps, host re-certification to gap "
        f"{model.last_certified_gap!r} <= {model.sse_threshold!r}, wall "
        f"{wall!r} s, best_sse {model.best_sse!r} (host search-only "
        f"{ref_sse!r}), R err {r_err!r}, t err/span {t_err!r}, outer_steps "
        f"{s.outer_steps} in all, translation_nodes {s.translation_nodes}, "
        f"host reads {trace.requests()[-1].host_reads}, "
        f"launches {launched}")
    if len(device_gaps) != 1 or not device_gaps[0] > model.sse_threshold:
        raise AssertionError("overflow: the device gap did not end open, or "
                             "the host loop did not re-certify")
    R, t = np.asarray(R), np.asarray(t)
    if not (np.all(np.isfinite(R)) and np.all(np.isfinite(t))):
        raise AssertionError("overflow: non-finite pose")
    if not model.last_certified_gap <= model.sse_threshold:
        raise AssertionError("overflow: the host loop did not close the gap")
    if not abs(model.best_sse - ref_sse) <= model.sse_threshold:
        raise AssertionError(f"overflow: best_sse {model.best_sse!r} not "
                             f"within sse_threshold of {ref_sse!r}")
    if launched["fused_bounds_lanes"] <= 0 or launched["nn_argmin"] <= 0:
        raise AssertionError("overflow: kernels never launched")

    walls, many = {}, {}
    for mode in ("device", "host"):
        for _ in range(2):
            t_run, cpu = time.time(), time.process_time()
            model = make(outer_mode=mode, so3_capacity=16384)
            R, t = model.run()
            torch.cuda.synchronize()
            wall, cpu = time.time() - t_run, time.process_time() - cpu
            walls[mode] = (wall, model.stats.outer_steps,
                           model.stats.translation_nodes, model.best_sse,
                           trace.requests()[-1].host_reads)
            if not model.last_certified_gap <= model.sse_threshold:
                raise AssertionError(f"many-step {mode}: not certified")
            many[mode] = rank_summary(model, R, t, wall, pair, cpu)
    say(f"many-step search (OVERFLOW_ENGINE, so3_capacity 16384), second "
        f"run of each: (wall s, outer_steps, translation_nodes, best_sse, "
        f"host reads) device {walls['device']!r}, host "
        f"{walls['host']!r}; known-pose error (R, t/span) of the certified "
        f"pose device {many['device']['pose_err']!r}, host "
        f"{many['host']['pose_err']!r}, of its basin's converged ICP device "
        f"{many['device']['basin_err']!r}, host {many['host']['basin_err']!r}")
    return many


# Phase 11's engine: phase 10d's many-step search (OVERFLOW_ENGINE at the
# default so3_capacity, 84-85 outer steps on one host), with every host's
# gather bounded: 10 s a round, 100 s for the first two (the initial ICP and
# the first step or chunk).
MULTIHOST_ENGINE = dict(OVERFLOW_ENGINE, so3_capacity=16384,
                        icp_multi_start=False, seed=0,
                        multihost_timeout_s=10.0)
HOSTS_JOIN_S = 300.0


def multihost_engine(**engine):
    from fgoicp_tpu_torch import EngineConfig
    return EngineConfig(**dict(MULTIHOST_ENGINE, **engine))


def rank_summary(model, R, t, wall, pair, cpu=None):
    """One host's result as plain numbers: wall, CPU seconds (the host's
    thread, or its process), incumbent, certificate,
    the protocol and search counters, the certified pose's error against
    the known pose ("pose_err", R max-abs, t max-abs / span) and that of
    its basin ("basin_err"): one converged ICP (the default engine's 100
    iterations to icp_convergence_final) from the certified pose on the
    full clouds.  OVERFLOW_ENGINE polishes with ten iterations, which stop
    short of the known pose (phase 10d), so the basin's pose carries the
    pose gate."""
    from fgoicp_tpu_torch import EngineConfig
    from fgoicp_tpu_torch.models.icp import icp_register
    d = EngineConfig()
    _, Rb, tb = icp_register(
        model.pct, model.pcs, model.best_rotation, model.best_translation,
        max_iter=d.icp_max_iter, convergence_threshold=d.icp_convergence_final)
    tb = model.norm.restore_translation(Rb, tb)
    s = model.stats
    return dict(
        wall=wall, cpu=cpu, best_sse=float(model.best_sse),
        gap=float(model.last_certified_gap),
        sse_threshold=float(model.sse_threshold),
        R=np.asarray(R, np.float64).tolist(),
        t=np.asarray(t, np.float64).tolist(), pose_err=pose_errors(R, t, pair),
        basin_err=pose_errors(Rb.cpu().numpy(), tb.cpu().numpy(), pair),
        sync_rounds=getattr(model, "sync_rounds", 0),
        idle_rounds=getattr(model, "idle_rounds", 0),
        donated=getattr(model, "donated_nodes", 0),
        stolen=getattr(model, "stolen_nodes", 0),
        outer_steps=s.outer_steps, rotation_children=s.rotation_children,
        translation_nodes=s.translation_nodes)


def thread_hosts(torch, dev, pair, engine, streams):
    """One MultiHostGoICP host per CUDA stream of `streams`, as threads of
    this process over ThreadCommunicator, each wrapped in
    ChaosCommunicator(delay_s=0) (gather digests) and run under its own
    stream (the caching allocator keeps its blocks per stream, so a caller
    that reuses the streams reuses the blocks).  A host's exception is
    re-raised, and so is a host still running after HOSTS_JOIN_S.  Returns
    (communicators, per-rank (model, R, t, wall, thread CPU seconds), phase
    wall, the process's CPU seconds over the phase, all its threads)."""
    import threading
    from fgoicp_tpu_torch.parallel import (ChaosCommunicator, MultiHostGoICP,
                                           ThreadCommunicator)
    n = len(streams)
    comms = ChaosCommunicator.wrap_all(ThreadCommunicator.create(n),
                                       delay_s=0.0)
    hosts, errors = [None] * n, []

    def host(rank):
        try:
            stream = streams[rank]
            with torch.cuda.stream(stream):
                t_run, cpu = time.time(), time.thread_time()
                model = MultiHostGoICP(pair[0], pair[1], comms[rank],
                                       mse_threshold=1e-3, engine=engine,
                                       device=dev)
                R, t = model.run()
                stream.synchronize()
                hosts[rank] = (model, R, t, time.time() - t_run,
                               time.thread_time() - cpu)
        except Exception as err:  # re-raised on the main thread
            errors.append((rank, err))

    threads = [threading.Thread(target=host, args=(r,), daemon=True)
               for r in range(n)]
    t_run, cpu = time.time(), time.process_time()
    for th in threads:
        th.start()
    deadline = t_run + HOSTS_JOIN_S
    for th in threads:
        th.join(timeout=max(0.0, deadline - time.time()))
    wall, cpu = time.time() - t_run, time.process_time() - cpu
    if errors:
        rank, err = errors[0]
        raise RuntimeError(f"thread host {rank} failed: {err!r}") from err
    alive = [r for r, th in enumerate(threads) if th.is_alive()]
    if alive:
        raise AssertionError(f"thread hosts {alive} still running after "
                             f"{HOSTS_JOIN_S} s")
    return comms, hosts, wall, cpu


def multihost_check(label, ranks, ref, phase_wall, smi_line, launched):
    """Print each rank's line and the phase's aggregate beside the single
    host's (ref), then gate: every rank certified at one best_sse, within
    sse_threshold of the single host's, check_result's pose gate on the
    certified pose's basin, conservation of stolen nodes, and the lane
    and NN kernels launched."""
    import types
    for r, h in enumerate(ranks):
        say(f"{label} rank {r}: wall {h['wall']!r} s, CPU {h['cpu']!r} s, "
            f"best_sse "
            f"{h['best_sse']!r}, gap {h['gap']!r} <= {h['sse_threshold']!r}, "
            f"R / t err of the certified pose {h['pose_err']!r}, of its "
            f"basin {h['basin_err']!r}, sync_rounds {h['sync_rounds']}, "
            f"idle_rounds {h['idle_rounds']}, donated / stolen "
            f"{h['donated']} / {h['stolen']}, outer_steps "
            f"{h['outer_steps']}, rotation_children "
            f"{h['rotation_children']}, translation_nodes "
            f"{h['translation_nodes']}")
    nodes = sum(h["translation_nodes"] for h in ranks)
    rate = sum(h["translation_nodes"] / h["wall"] for h in ranks)
    say(f"{label} ({smi_line}): {len(ranks)} hosts, wall {phase_wall!r} s "
        f"against the single host's {ref['wall']!r} s (process CPU "
        f"{ref['cpu']!r} s); translation nodes "
        f"{nodes} against {ref['translation_nodes']}, outer steps "
        f"{sum(h['outer_steps'] for h in ranks)} against "
        f"{ref['outer_steps']}; translation nodes per second summed over "
        f"ranks {rate!r} against the single host's "
        f"{ref['translation_nodes'] / ref['wall']!r}; kernel launches "
        f"(sums over all hosts) {launched}")
    for r, h in enumerate(ranks):
        model = types.SimpleNamespace(last_certified_gap=h["gap"],
                                      sse_threshold=h["sse_threshold"])
        check_result(f"{label} rank {r}", model, h["R"], h["t"],
                     *h["basin_err"])
        if not abs(h["best_sse"] - ref["best_sse"]) <= h["sse_threshold"]:
            raise AssertionError(
                f"{label} rank {r}: best_sse {h['best_sse']!r} not within "
                f"sse_threshold of the single host's {ref['best_sse']!r}")
    best = [h["best_sse"] for h in ranks]
    if max(best) - min(best) > 1e-6 * max(1.0, max(best)):
        raise AssertionError(f"{label}: ranks end at different best_sse "
                             f"{best!r}")
    if sum(h["donated"] for h in ranks) != sum(h["stolen"] for h in ranks):
        raise AssertionError(f"{label}: donated != stolen nodes")
    if launched["fused_bounds_lanes"] <= 0 or launched["nn_argmin"] <= 0:
        raise AssertionError(f"{label}: fused_bounds_lanes or nn_argmin "
                             f"never launched")


def multihost_worker(rank, port, out_path) -> int:
    """Phase 11c's worker (`chip_smoke.py --multihost-worker RANK PORT
    OUT`): join a two-process gloo group on localhost:PORT through
    initialize(), run 11a's engine in host mode twice over
    ChaosCommunicator(delay_s=0), and write each run's rank_summary, kernel
    launches and gather digests to OUT as JSON."""
    import torch
    if not torch.cuda.is_available():
        print("multihost worker: no CUDA device", file=sys.stderr)
        return 1
    import torch.distributed
    from fgoicp_tpu_torch.parallel import (ChaosCommunicator, MultiHostGoICP,
                                           initialize)
    pair = workloads.smoke_pair()
    dev = torch.device("cuda")
    comm = ChaosCommunicator(initialize(f"localhost:{port}", 2, rank),
                             delay_s=0.0)
    runs = []
    for _ in range(2):
        snap = snapshot()
        seen = len(comm.digests)
        torch.cuda.synchronize()
        t_run, cpu = time.time(), time.process_time()
        model = MultiHostGoICP(pair[0], pair[1], comm, mse_threshold=1e-3,
                               engine=multihost_engine(**MULTIHOST_A),
                               device=dev)
        R, t = model.run()
        torch.cuda.synchronize()
        wall, cpu = time.time() - t_run, time.process_time() - cpu
        runs.append(dict(rank_summary(model, R, t, wall, pair, cpu),
                         launched=since(snap)[0],
                         digests=[d.hex() for d in comm.digests[seen:]]))
    torch.distributed.destroy_process_group()
    pathlib.Path(out_path).write_text(json.dumps(runs))
    return 0


def process_hosts():
    """Phase 11c's two worker processes on this card: this script in worker
    mode, with the launcher's distributed variables taken out of the
    environment and a free localhost port.  Returns each rank's runs; a
    worker's nonzero exit fails the phase, and both are stopped on the way
    out."""
    import os
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
        "MASTER_ADDR", "MASTER_PORT", "GROUP_RANK", "TORCHELASTIC_RUN_ID")}
    outs = [WORK / f"multihost_rank{r}.json" for r in range(2)]
    logs = [WORK / f"multihost_rank{r}.log" for r in range(2)]
    for path in outs:
        path.unlink(missing_ok=True)
    procs = []
    try:
        for r in range(2):
            with open(logs[r], "w") as log_file:
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"),
                     "--multihost-worker", str(r), str(port), str(outs[r])],
                    cwd=ROOT, env=env, stdout=log_file,
                    stderr=subprocess.STDOUT))
        deadline = time.time() + 2 * HOSTS_JOIN_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(
                f"11c worker {r} exited {p.returncode}:\n"
                f"{logs[r].read_text()[-3000:]}")
    return [json.loads(path.read_text()) for path in outs]


# 11a's protocol settings (11c runs them too) and 11b's.
MULTIHOST_A = dict(outer_mode="host", multihost_sync_every=1,
                   multihost_steal_max=8)
MULTIHOST_B = dict(outer_mode="device", multihost_sync_every=4,
                   multihost_steal_max=4)


def multihost_phase(torch, dev, pair, many, smi_line):
    """Phase 11: the multi-host outer BnB (fgoicp_tpu_torch/parallel) on
    the many-step engine of phase 10d, against its single-host runs
    (`many`).  11a: 4 thread hosts, host mode; 11b: 2 thread hosts, device
    mode; each run twice, with verify_agreement and verify_conservation,
    and 11a once more at a 0.1 ms interpreter switch interval.  11c: 2
    processes on this card over gloo, host mode, each run twice: equal
    gather digests on both ranks; beside them the same search as 2 thread
    hosts."""
    from fgoicp_tpu_torch.parallel import (verify_agreement,
                                           verify_conservation)

    def threads_run(label, streams, kw, mode):
        n = len(streams)
        snap = snapshot()
        comms, hosts, wall, cpu = thread_hosts(
            torch, dev, pair, multihost_engine(**kw), streams)
        launched = since(snap)[0]
        ranks = [rank_summary(m, R, t, w, pair, c)
                 for m, R, t, w, c in hosts]
        say(f"{label}: process CPU {cpu!r} s over the phase wall {wall!r} s")
        multihost_check(f"{label} ({n} thread hosts, {kw})", ranks,
                        many[mode], wall, smi_line, launched)
        rounds = verify_agreement(comms)
        verify_conservation([h[0] for h in hosts])
        say(f"{label}: verify_agreement {rounds} collectives, "
            f"verify_conservation ok")
        return ranks, comms, wall

    def new_streams(n):
        return [torch.cuda.Stream(device=dev) for _ in range(n)]

    # Each sub-phase makes its hosts' streams once: its first run fills
    # their allocator pools, the second reuses them.
    switch = sys.getswitchinterval()
    streams = {"11a": new_streams(4), "11b": new_streams(2)}
    for label, kw, mode in (("11a", MULTIHOST_A, "host"),
                            ("11b", MULTIHOST_B, "device")):
        for run in ("first", "second"):
            threads_run(f"{label} {run}", streams[label], kw, mode)
    # Thread hosts release the GIL inside each torch op and wait for it
    # again after it; a shorter switch interval bounds that wait.
    sys.setswitchinterval(1e-4)
    try:
        threads_run("11a at switch interval 1e-4 s", streams["11a"],
                    MULTIHOST_A, "host")
    finally:
        sys.setswitchinterval(switch)
    # 11c's search as two thread hosts, for its processes' comparison.
    twin_streams = new_streams(2)
    for run in ("first", "second"):
        twins, twin_comms, twin_wall = threads_run(
            f"11c's twin {run}", twin_streams, MULTIHOST_A, "host")
    t_run = time.time()
    by_rank = process_hosts()
    wall = time.time() - t_run
    say(f"11c: 2 processes, wall {wall!r} s from start to exit")
    for i, run in enumerate(("first", "second")):
        ranks = [runs[i] for runs in by_rank]
        launched = {k: sum(h["launched"][k] for h in ranks)
                    for k in ranks[0]["launched"]}
        multihost_check(f"11c {run} (2 gloo processes, {MULTIHOST_A})",
                        ranks, many["host"], max(h["wall"] for h in ranks),
                        smi_line, launched)
        if ranks[0]["digests"] != ranks[1]["digests"] \
                or not ranks[0]["digests"]:
            raise AssertionError(f"11c {run}: the ranks' gather digests "
                                 f"differ")
        say(f"11c {run}: {len(ranks[0]['digests'])} gathers, digests equal "
            f"on both ranks")
    keys = ("best_sse", "sync_rounds", "idle_rounds", "donated", "stolen",
            "outer_steps", "rotation_children", "translation_nodes")
    same = all(h[k] == w[k] for h, w in zip(ranks, twins) for k in keys) \
        and ranks[0]["digests"] == [d.hex() for d in twin_comms[0].digests]
    say(f"11c against its twin of 2 thread hosts ({smi_line}): second run "
        f"wall {max(h['wall'] for h in ranks)!r} s against {twin_wall!r} s; "
        f"counters, best_sse and digests "
        f"{'equal' if same else 'DIFFERENT'}")


# Phase 12's sub-phases: (label, mesh_cubes, mesh_points).  Every rank is a
# gloo process on this one card (NCCL refuses two ranks on one GPU): the
# phase proves the sharded math and the protocol on the card's kernels and
# measures no scaling.
MESH_PHASES = (("12a", 2, 1), ("12b", 1, 2), ("12c", 2, 2), ("12d", 2, 1))
MESH_JOIN_S = 400.0


def mesh_run_summary(label, kind, model, R, t, wall, truth, launched):
    """One mesh rank's registration as plain numbers, with the digest of
    what every rank must hold alike (pose, incumbent, certificate, search
    counters)."""
    import hashlib
    s = model.stats
    counters = [s.translation_nodes, s.rotation_children, s.outer_steps,
                s.inner_loop_steps, s.icp_runs]
    digest = hashlib.sha256(
        np.asarray(R, np.float64).tobytes() + np.asarray(t, np.float64)
        .tobytes() + np.asarray([model.best_sse, model.last_certified_gap],
                                np.float64).tobytes()
        + np.asarray(counters, np.int64).tobytes()).hexdigest()
    return dict(label=label, kind=kind, wall=wall,
                best_sse=float(model.best_sse),
                gap=float(model.last_certified_gap),
                sse_threshold=float(model.sse_threshold),
                R=np.asarray(R, np.float64).tolist(),
                t=np.asarray(t, np.float64).tolist(),
                pose_err=pose_errors(R, t, truth),
                translation_nodes=s.translation_nodes,
                outer_steps=s.outer_steps,
                inner_loop_steps=s.inner_loop_steps,
                mesh=model.mesh.counters(), launched=launched, digest=digest)


def mesh_worker(label, nc, np_, rank, port, out_path) -> int:
    """Phase 12's worker (`chip_smoke.py --mesh-worker LABEL NC NP RANK PORT
    OUT`): one rank of an nc x np_ mesh on this card, joined by the user
    entry points themselves (register(Config) with engine.mesh_cubes /
    mesh_points, or make_mesh for serving) over env://, as torchrun starts
    ranks.  Runs the sub-phase cold, then warm, in this process and writes
    its summaries to OUT.  Rank 0 records its cold runs' kernel launches
    (kernel_check's `Recorder`) and, once the mesh is down, holds each
    launch shape against the kernel's plain version."""
    import os
    import torch
    if not torch.cuda.is_available():
        print("mesh worker: no CUDA device", file=sys.stderr)
        return 1
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(nc * np_),
                      LOCAL_WORLD_SIZE=str(nc * np_),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import torch.distributed
    from fgoicp_tpu_torch import Config, load_cloud, register
    rec = kc.Recorder() if rank == 0 else None

    def recording(run, name):
        """Rank 0's cold runs keep their launches' arguments."""
        if rec is None or run != "cold":
            return contextlib.nullcontext()
        return rec.record(f"{label} {name}")

    def drive(name, kind, truth, **engine):
        """register() cold, then warm: [(model, summary)] of both runs."""
        cfg = Config.from_toml(str(WORK / f"{name}.toml"))
        for key, value in dict(engine, icp_multi_start=False,
                               mesh_cubes=nc, mesh_points=np_).items():
            setattr(cfg.engine, key, value)
        pct, pcs = load_cloud(cfg.io.target), load_cloud(cfg.io.source)
        out = []
        for run in ("cold", "warm"):
            snap = snapshot()
            torch.cuda.synchronize()
            t_run = time.time()
            with recording(run, kind):
                model, R, t = register(cfg, pct, pcs, device="cuda")
            torch.cuda.synchronize()
            wall = time.time() - t_run
            out.append((model, mesh_run_summary(
                f"{label} {kind} {run}", kind, model, R, t, wall, truth,
                since(snap)[0])))
        return out

    pair = workloads.smoke_pair()
    runs = []
    if label == "12d":
        import hashlib
        from fgoicp_tpu_torch.models.serving import RegistrationService
        from fgoicp_tpu_torch.parallel import make_mesh
        data = workloads.serving_data()
        mesh = make_mesh(nc, np_, device="cuda")
        srv = RegistrationService(data["pct"], mse_threshold=1e-3,
                                  mesh=mesh, device="cuda")
        for run in ("cold", "warm"):
            snap = snapshot()
            mesh.reset_counters()
            fallbacks = srv.stats.fallbacks
            torch.cuda.synchronize()
            t_run = time.time()
            with recording(run, "serving"):
                results = srv.register(data["sources"])
            torch.cuda.synchronize()
            wall = time.time() - t_run
            arrays = [np.stack([r.R for r in results]).astype(np.float64),
                      np.stack([r.t for r in results]).astype(np.float64),
                      np.asarray([r.sse for r in results], np.float64),
                      np.asarray([r.certified for r in results])]
            runs.append(dict(
                label=f"{label} serving {run}", kind="serving", wall=wall,
                sse=arrays[2].tolist(), certified=arrays[3].tolist(),
                R=arrays[0].tolist(), t=arrays[1].tolist(),
                fallbacks=srv.stats.fallbacks - fallbacks,
                mesh=mesh.counters(),
                launched=since(snap)[0],
                digest=hashlib.sha256(b"".join(a.tobytes() for a in arrays))
                .hexdigest()))
    elif label == "12b":
        runs += [summary for _, summary in drive("smoke", "smoke", pair)]
        runs += [summary for _, summary in drive(
            "smoke", "grouped", pair, frontier_mode="grouped")]
        runs += [summary for _, summary in drive(
            "trimmed", "trimmed", workloads.trimmed_pair())]
    else:
        runs += [summary for _, summary in drive(
            "smoke", "device" if label == "12c" else "smoke", pair,
            **(dict(outer_mode="device") if label == "12c" else {}))]
    torch.distributed.destroy_process_group()
    if rec is not None:
        runs[0]["shard_kernels"] = rec.check()
    pathlib.Path(out_path).write_text(json.dumps(runs))
    return 0


def mesh_processes(label, nc, np_, hosts=1):
    """One sub-phase's hosts x nc x np_ worker processes on this card
    (`--mesh-worker`, or `--hostmesh-worker` for hosts on meshes), with the
    launcher's distributed variables taken out of the environment and a
    free localhost port.  Returns each rank's runs and the wall from start
    to exit; a worker's nonzero exit fails the phase, and every worker is
    stopped on the way out."""
    import os
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
        "MASTER_ADDR", "MASTER_PORT", "GROUP_RANK", "TORCHELASTIC_RUN_ID")}
    n = hosts * nc * np_
    mode = "--mesh-worker" if hosts == 1 else "--hostmesh-worker"
    outs = [WORK / f"mesh_{label}_rank{r}.json" for r in range(n)]
    logs = [WORK / f"mesh_{label}_rank{r}.log" for r in range(n)]
    for path in outs:
        path.unlink(missing_ok=True)
    procs = []
    t_run = time.time()
    try:
        for r in range(n):
            with open(logs[r], "w") as log_file:
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"),
                     mode, label, str(nc), str(np_), str(r),
                     str(port), str(outs[r])],
                    cwd=ROOT, env=env, stdout=log_file,
                    stderr=subprocess.STDOUT))
        deadline = time.time() + MESH_JOIN_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.time() - t_run
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(
                f"{label} worker {r} exited {p.returncode}:\n"
                f"{logs[r].read_text()[-3000:]}")
    return [json.loads(path.read_text()) for path in outs], wall


def mesh_phase(refs, refs_wall, served, serving, smi_line):
    """Phase 12: the device mesh (fgoicp_tpu_torch/parallel/sharding.py,
    bnb.py) as gloo processes sharing this card, one run per sub-phase:
    12a (2, 1) search-only on the smoke pair; 12b (1, 2) search-only, the
    grouped scheduler search-only, then trimmed search-only on the 20k / 10k
    pair; 12c (2, 2) device outer mode on the smoke pair; 12d 9a's 32-pair
    batch served on (2, 1).  Every rank must certify with the known pose,
    every rank's digest must be equal, best_sse within sse_threshold of the
    single-device phase's (`refs`: phase 4, 6, 5 and 10a's warm runs, whose
    register() walls are `refs_wall`; `served`: 9a's results) and the
    path's kernels launched.  Rank 0 of each sub-phase holds every shape
    at which its cold runs launched a kernel against the plain versions;
    nn_argmin, nn_min, fused_bounds_lanes and fused_bounds must each be held
    at some shape.  Returns the held rows."""
    import types
    need = {"smoke": ("nn_argmin", "fused_bounds_lanes"),
            "grouped": ("nn_argmin", "fused_bounds"),
            "trimmed": ("nn_argmin", "nn_min"),
            "device": ("nn_argmin", "nn_min", "fused_bounds_lanes"),
            "serving": ("nn_argmin", "nn_min")}
    rows = []
    for label, nc, np_ in MESH_PHASES:
        by_rank, wall = mesh_processes(label, nc, np_)
        rows += by_rank[0][0].get("shard_kernels", [])
        say(f"{label} ({smi_line}): {nc} x {np_} mesh, {nc * np_} gloo "
            f"processes on one card, wall {wall!r} s from start to exit")
        for i in range(len(by_rank[0])):
            ranks = [runs[i] for runs in by_rank]
            name, kind = ranks[0]["label"], ranks[0]["kind"]
            launched = {k: sum(h["launched"][k] for h in ranks)
                        for k in ranks[0]["launched"]}
            for r, h in enumerate(ranks):
                nodes = ("" if kind == "serving" else
                         f"translation_nodes {h['translation_nodes']}, "
                         f"outer_steps {h['outer_steps']}, inner_loop_steps "
                         f"{h['inner_loop_steps']}, best_sse "
                         f"{h['best_sse']!r}, gap {h['gap']!r} <= "
                         f"{h['sse_threshold']!r}, R / t err "
                         f"{h['pose_err']!r}, ")
                say(f"{name} rank {r} ({smi_line}): wall {h['wall']!r} s, "
                    f"{nodes}collectives {h['mesh']['collectives']}, "
                    f"gathered bytes {h['mesh']['bytes']}, host copies "
                    f"{h['mesh']['host_copies']}, launches {h['launched']}")
            if len({h["digest"] for h in ranks}) != 1:
                raise AssertionError(f"{name}: the ranks' digests differ")
            missing = [k for k in need[kind] if launched[k] <= 0]
            if missing:
                raise AssertionError(f"{name}: kernels {missing} never "
                                     f"launched")
            if kind == "serving":
                ns = serving["sources"].shape[1]
                h = ranks[0]
                serving_checks(name, [types.SimpleNamespace(
                    R=np.asarray(R), t=np.asarray(t), sse=sse, mse=sse / ns,
                    certified=c) for R, t, sse, c in zip(
                        h["R"], h["t"], h["sse"], h["certified"])],
                    serving["truth"], serving["span"], 5e-3)
                # A pair's sse_threshold: ns * mse_threshold (1e-3).
                far = [i for i, (a, b) in enumerate(zip(
                    h["sse"], [r.sse for r in served]))
                    if abs(a - b) > ns * 1e-3]
                if far:
                    raise AssertionError(f"{name}: pairs {far} not within "
                                         f"sse_threshold of 9a's")
                say(f"{name}: every pair certified at its known pose, sse "
                    f"within sse_threshold of 9a's, fallbacks "
                    f"{ranks[0]['fallbacks']}, digests equal on "
                    f"{len(ranks)} ranks")
                continue
            if kind == "trimmed" and launched["fused_bounds_lanes_trimmed"]:
                raise AssertionError(f"{name}: point-sharded trimming "
                                     f"launched the trimmed lane kernel")
            ref = refs[kind]
            for r, h in enumerate(ranks):
                check_result(f"{name} rank {r}", types.SimpleNamespace(
                    last_certified_gap=h["gap"],
                    sse_threshold=h["sse_threshold"]), h["R"], h["t"],
                    *h["pose_err"])
                if not abs(h["best_sse"] - ref.best_sse) <= \
                        h["sse_threshold"]:
                    raise AssertionError(
                        f"{name} rank {r}: best_sse {h['best_sse']!r} not "
                        f"within sse_threshold of the single device's "
                        f"{ref.best_sse!r}")
            say(f"{name} ({smi_line}): certified on {len(ranks)} ranks, "
                f"digests equal, best_sse {ranks[0]['best_sse']!r} against "
                f"the single device's {ref.best_sse!r}, translation nodes "
                f"{ranks[0]['translation_nodes']} against "
                f"{ref.stats.translation_nodes}, wall (register) "
                f"{[h['wall'] for h in ranks]!r} s against the single "
                f"device's warm {refs_wall[kind]!r} s, kernel launches "
                f"summed over ranks {launched}")
    held("phase 12 rank 0", rows, smi_line, need=(
        "nn_argmin", "nn_min", "fused_bounds_lanes", "fused_bounds"))
    return rows


# Phase 13's sub-phases: (label, mesh_cubes, mesh_points, protocol settings,
# GoICP keywords), each on HOST_MESH_HOSTS hosts of nc x np_ ranks, every
# rank a gloo process on this one card, as in phases 11c and 12.
HOST_MESH_HOSTS = 2
HOST_MESH_PHASES = (
    ("13a", 1, 2, MULTIHOST_A, {}),
    ("13b", 2, 1, MULTIHOST_B, {}),
    ("13c", 2, 1, MULTIHOST_A, dict(bound_backend="lut",
                                    lut_resolution=LUT_RESOLUTION)))


def state_digest(model, R, t):
    """What the mesh ranks of one host must hold alike: the pose, the
    incumbent, the certificate and the search and protocol counters."""
    import hashlib
    s = model.stats
    return hashlib.sha256(
        np.asarray(R, np.float64).tobytes() + np.asarray(t, np.float64)
        .tobytes() + np.asarray([model.best_sse, model.last_certified_gap],
                                np.float64).tobytes()
        + np.asarray([s.translation_nodes, s.rotation_children,
                      s.outer_steps, s.inner_loop_steps, s.icp_runs,
                      model.sync_rounds, model.idle_rounds,
                      model.donated_nodes, model.stolen_nodes],
                     np.int64).tobytes()).hexdigest()


def hostmesh_worker(label, nc, np_, rank, port, out_path) -> int:
    """Phase 13's worker (`chip_smoke.py --hostmesh-worker LABEL NC NP RANK
    PORT OUT`): one rank of HOST_MESH_HOSTS hosts, each on an nc x np_ mesh
    of this card, joined over gloo by initialize() and make_host_mesh() (the
    meshes, then one host group a mesh position).  Runs the sub-phase's
    MultiHostGoICP cold, then warm, over ChaosCommunicator(delay_s=0) and
    writes each run's rank_summary, launches, gather digests, mesh counters
    and state digest to OUT.  Rank 0 records its cold run's launches
    (kernel_check's `Recorder`) and holds each shape against its plain
    version once the world is down."""
    import torch
    if not torch.cuda.is_available():
        print("host-mesh worker: no CUDA device", file=sys.stderr)
        return 1
    import torch.distributed
    from fgoicp_tpu_torch.parallel import ChaosCommunicator, initialize
    from fgoicp_tpu_torch.parallel.distributed import (MultiHostGoICP,
                                                       make_host_mesh)
    (kw, extra), = [(k, e) for lab, _, _, k, e in HOST_MESH_PHASES
                    if lab == label]
    pair = workloads.smoke_pair()
    initialize(f"localhost:{port}", HOST_MESH_HOSTS * nc * np_, rank,
               timeout=HOSTS_JOIN_S)
    inner, mesh = make_host_mesh(HOST_MESH_HOSTS, nc, np_, device="cuda",
                                 timeout=HOSTS_JOIN_S)
    comm = ChaosCommunicator(inner, delay_s=0.0)
    rec = kc.Recorder() if rank == 0 else None
    kind = "lut" if extra else kw["outer_mode"]
    runs = []
    for run in ("cold", "warm"):
        snap = snapshot()
        mesh.reset_counters()
        seen = len(comm.digests)
        recording = (rec.record(f"{label} {kind}")
                     if rec is not None and run == "cold"
                     else contextlib.nullcontext())
        torch.cuda.synchronize()
        t_run, cpu = time.time(), time.process_time()
        with recording:
            model = MultiHostGoICP(pair[0], pair[1], comm, mse_threshold=1e-3,
                                   engine=multihost_engine(**kw), mesh=mesh,
                                   device="cuda", **extra)
            R, t = model.run()
        torch.cuda.synchronize()
        wall, cpu = time.time() - t_run, time.process_time() - cpu
        runs.append(dict(
            rank_summary(model, R, t, wall, pair, cpu), label=label,
            run=run, kind=kind, host=mesh.host, position=mesh.rank,
            launched=since(snap)[0],
            digests=[d.hex() for d in comm.digests[seen:]],
            mesh=mesh.counters(), state=state_digest(model, R, t)))
    torch.distributed.destroy_process_group()
    if rec is not None:
        runs[0]["shard_kernels"] = rec.check()
    pathlib.Path(out_path).write_text(json.dumps(runs))
    return 0


def hostmesh_phase(many, smi_line):
    """Phase 13: hosts on meshes, HOST_MESH_HOSTS hosts of nc x np_ gloo
    processes on this card, each sub-phase cold then warm.  Gate on every
    rank: the certificate and check_result's pose gate on the certified
    pose's basin, best_sse within sse_threshold of phase 11's single host
    (`many` by outer mode); every rank's gather digests equal (the host
    groups of all mesh positions agree), a host's mesh ranks with equal
    state digests, donated == stolen counted at each host's mesh position
    0, the path's kernels launched (13c: minplus_1d three times a rank and
    no proxy lane kernel).  Rank 0's cold-run launch shapes are held against
    the plain versions; minplus_1d (13c), fused_bounds_lanes and nn_argmin
    must each be held.  Returns the held rows."""
    import types
    rows = []
    for label, nc, np_, kw, extra in HOST_MESH_PHASES:
        by_rank, wall = mesh_processes(label, nc, np_, hosts=HOST_MESH_HOSTS)
        rows += by_rank[0][0].get("shard_kernels", [])
        n = HOST_MESH_HOSTS * nc * np_
        say(f"{label} ({smi_line}): {HOST_MESH_HOSTS} hosts x {nc} x {np_} "
            f"mesh, {n} gloo processes on one card, {kw}, {extra or ''} "
            f"wall {wall!r} s from start to exit")
        for i, run in enumerate(("cold", "warm")):
            ranks = [runs[i] for runs in by_rank]
            kind = ranks[0]["kind"]
            name = f"{label} {kind} {run}"
            ref = many["device" if kind == "device" else "host"]
            launched = {k: sum(h["launched"][k] for h in ranks)
                        for k in ranks[0]["launched"]}
            for r, h in enumerate(ranks):
                say(f"{name} rank {r} (host {h['host']}, mesh position "
                    f"{h['position']}) ({smi_line}): wall {h['wall']!r} s, "
                    f"CPU {h['cpu']!r} s, best_sse {h['best_sse']!r}, gap "
                    f"{h['gap']!r} <= {h['sse_threshold']!r}, basin R / t "
                    f"err {h['basin_err']!r}, sync_rounds "
                    f"{h['sync_rounds']}, idle_rounds {h['idle_rounds']}, "
                    f"donated / stolen {h['donated']} / {h['stolen']}, "
                    f"outer_steps {h['outer_steps']}, translation_nodes "
                    f"{h['translation_nodes']}, gathers "
                    f"{len(h['digests'])}, collectives "
                    f"{h['mesh']['collectives']}, gathered bytes "
                    f"{h['mesh']['bytes']}, host copies "
                    f"{h['mesh']['host_copies']}, launches {h['launched']}")
            for r, h in enumerate(ranks):
                check_result(f"{name} rank {r}", types.SimpleNamespace(
                    last_certified_gap=h["gap"],
                    sse_threshold=h["sse_threshold"]), h["R"], h["t"],
                    *h["basin_err"])
                if not abs(h["best_sse"] - ref["best_sse"]) <= \
                        h["sse_threshold"]:
                    raise AssertionError(
                        f"{name} rank {r}: best_sse {h['best_sse']!r} not "
                        f"within sse_threshold of phase 11's single host "
                        f"{ref['best_sse']!r}")
            digests = {json.dumps(h["digests"]) for h in ranks}
            if len(digests) != 1 or not ranks[0]["digests"]:
                raise AssertionError(f"{name}: the ranks' gather digests "
                                     f"differ (verify_agreement)")
            for host in range(HOST_MESH_HOSTS):
                if len({h["state"] for h in ranks
                        if h["host"] == host}) != 1:
                    raise AssertionError(f"{name}: host {host}'s mesh ranks "
                                         f"hold different states")
            firsts = [h for h in ranks if h["position"] == 0]
            if sum(h["donated"] for h in firsts) != \
                    sum(h["stolen"] for h in firsts):
                raise AssertionError(f"{name}: donated != stolen nodes "
                                     f"(verify_conservation)")
            need = (("nn_argmin", "minplus_1d") if kind == "lut"
                    else ("nn_argmin", "fused_bounds_lanes"))
            missing = [k for k in need if launched[k] <= 0]
            if missing:
                raise AssertionError(f"{name}: kernels {missing} never "
                                     f"launched")
            if kind == "lut" and (launched["minplus_1d"] != 3 * n or
                                  launched["fused_bounds_lanes"]):
                raise AssertionError(
                    f"{name}: minplus_1d launched {launched['minplus_1d']} "
                    f"times (not 3 a rank) or a proxy lane kernel ran")
            say(f"{name} ({smi_line}): certified on {n} ranks within "
                f"sse_threshold of phase 11's single host "
                f"({ref['best_sse']!r}, wall {ref['wall']!r} s), gather "
                f"digests equal on every rank ({len(ranks[0]['digests'])} "
                f"gathers), state digests equal within each host, donated / "
                f"stolen {sum(h['donated'] for h in firsts)} / "
                f"{sum(h['stolen'] for h in firsts)}, walls "
                f"{[h['wall'] for h in ranks]!r} s, translation nodes summed "
                f"over hosts {sum(h['translation_nodes'] for h in firsts)} "
                f"against {ref['translation_nodes']}, kernel launches summed "
                f"over ranks {launched}")
    held("phase 13 rank 0", rows, smi_line, need=(
        "minplus_1d", "fused_bounds_lanes", "nn_argmin"))
    return rows


def merge_phase(drive, require, cfg, pct_in, pcs_in, pair, sort_runs,
                smi_line):
    """Phase 14a: search-only and device search-only with
    pool_update="merge", cold then warm; each certifies at the known pose
    (drive's gate) with best_sse within sse_threshold of the sort runs'
    (`sort_runs`: phase 4's and 10a's), nodes and steps printed beside."""
    for label, outer in (("merge search-only", "host"),
                         ("merge device search-only", "device")):
        runs = drive(label, cfg, pct_in, pcs_in, pair,
                     icp_multi_start=False, outer_mode=outer,
                     pool_update="merge")
        require(label, runs, ["nn_argmin", "nn_min", "fused_bounds_lanes"])
        ref = sort_runs[outer]["warm"]["model"]
        m = runs["warm"]["model"]
        if not abs(m.best_sse - ref.best_sse) <= m.sse_threshold:
            raise AssertionError(f"{label}: best_sse {m.best_sse!r} not "
                                 f"within sse_threshold of sort's "
                                 f"{ref.best_sse!r}")
        say(f"{label} ({smi_line}): best_sse {m.best_sse!r} against sort's "
            f"{ref.best_sse!r}; translation nodes "
            f"{m.stats.translation_nodes} against "
            f"{ref.stats.translation_nodes}, inner steps "
            f"{m.stats.inner_loop_steps} against "
            f"{ref.stats.inner_loop_steps}, outer steps "
            f"{m.stats.outer_steps} against {ref.stats.outer_steps}; warm "
            f"wall {runs['warm']['wall']!r} s against "
            f"{sort_runs[outer]['warm']['wall']!r} s")
    cfg.engine.pool_update, cfg.engine.outer_mode = "sort", "host"


def cli_phase(smi_line):
    """Phase 14b: the CLI on the smoke pair, search-only, three processes
    started together: no flag, --debug-nans and --profile DIR.  Gates: each
    exits 0; --debug-nans writes the result TOML of the run without it
    (elapsed time and rate aside); the --profile trace parses, names the
    port's kernels (nn_kernel, bounds_lanes_kernel) and holds the program's
    ranges of the request, its ICPs and its reads (utils/trace.py)."""
    import shutil
    import tomllib

    from fgoicp_tpu_torch.utils import trace as prog_trace
    prof = WORK / "cli_profile"
    shutil.rmtree(prof, ignore_errors=True)
    runs = {"plain": [], "debug-nans": ["--debug-nans"],
            "profile": ["--profile", str(prof)]}
    procs = {}
    for name, flags in runs.items():
        out = WORK / f"cli_{name}.toml"
        out.unlink(missing_ok=True)
        cfg = WORK / f"cli_{name}_run.toml"
        cfg.write_text(
            f'[io]\ntarget = "{WORK / "smoke_target.ply"}"\n'
            f'source = "{WORK / "smoke_source.ply"}"\noutput = "{out}"\n\n'
            f'[params]\nmse_threshold = 1e-3\n\n[engine]\nseed = 0\n'
            f'icp_multi_start = false\n')
        log = open(WORK / f"cli_{name}.log", "w")
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", "fgoicp_tpu_torch", "-c", str(cfg),
             *flags], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT), out,
            log)
    t_run = time.time()
    results = {}
    try:
        for name, (proc, out, log) in procs.items():
            proc.wait(timeout=max(1.0, 300 - (time.time() - t_run)))
    finally:
        for name, (proc, out, log) in procs.items():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for name, (proc, out, log) in procs.items():
        if proc.returncode != 0:
            raise AssertionError(
                f"CLI {name} exited {proc.returncode}:\n"
                f"{(WORK / f'cli_{name}.log').read_text()[-3000:]}")
        res = tomllib.loads(out.read_text())
        say(f"CLI {name} ({smi_line}): sse {res['result']['sse']!r}, "
            f"elapsed {res['result']['elapsed_seconds']!r} s, stats "
            f"{res['stats']}")
        res["result"].pop("elapsed_seconds")
        res["stats"].pop("cubes_per_second")
        results[name] = res
    if results["debug-nans"] != results["plain"]:
        raise AssertionError("CLI --debug-nans: the result differs from the "
                             "run without it")
    trace = json.loads((prof / "trace_rank0.json").read_text())
    names = {}
    for e in trace.get("traceEvents", []):
        for k in ("nn_kernel", "bounds_lanes_kernel"):
            if k in str(e.get("name", "")) and e.get("cat") == "kernel":
                names[k] = names.get(k, 0) + 1
    if set(names) != {"nn_kernel", "bounds_lanes_kernel"}:
        raise AssertionError(f"CLI --profile: the trace's device kernels "
                             f"{names} do not name the port's kernels")
    ranges = {}
    for e in trace.get("traceEvents", []):
        name = str(e.get("name", ""))
        if name.startswith(prog_trace.PREFIX) and e.get("cat") != "kernel":
            span = prog_trace.parse_range(name)[0]
            ranges[span] = ranges.get(span, 0) + 1
    if not {"register", "icp", "read"} <= set(ranges):
        raise AssertionError(f"CLI --profile: the program's ranges {ranges} "
                             f"lack the request, its ICPs or its reads")
    say(f"CLI --profile ({smi_line}): {len(trace['traceEvents'])} trace "
        f"events, device kernel events by name {names}, program ranges by "
        f"span {ranges}; --debug-nans: result equal to the run without it")


def tools_phase(torch, trimmed_nodes, smi_line):
    """Phase 15: the experiment tools of fgoicp_tpu_torch/scripts, called as
    functions at their defaults, each with its launches counted over it,
    and every launch shape it gives the kernels held against the plain
    versions afterwards (kernel_check's `Recorder`).  Gates: 15a
    step_decomp's pieces sum to no more than a step; 15b micro_step's bare
    kernel to no more than a pooled step; 15c
    mxu_experiment launches nn_min (its norm-expansion errors are printed,
    not gated); 15d minplus_experiment's f64 gate, its kernel bit-equal to
    the plain version at [262,144 x 1,024] and the two EDT fields equal;
    15e hard_pairs --pair synth in host and device outer mode: certified,
    the seeding's gap open, rotation_children > 0 and more translation
    nodes than phase 5's trimmed search-only (`trimmed_nodes`), and the
    certified pose in the known pose's basin (R < 5e-3, t < 5e-3 x span
    after one converged trimmed ICP); 15f serving_experiment ragged and
    fallback: every pair certified, and the fallback mode takes a fallback
    that launches fused_bounds_lanes_trimmed; every kernel but
    fused_bounds held at some shape.  Returns the held rows."""
    from fgoicp_tpu_torch.scripts import (
        hard_pairs, micro_step, minplus_experiment, mxu_experiment,
        serving_experiment, step_decomp)
    rec = kc.Recorder()

    def tool(label, call, need):
        snap = snapshot()
        t_run = time.time()
        with rec.record(label):
            out = call()
        torch.cuda.synchronize()
        wall = time.time() - t_run
        launched = since(snap)[0]
        say(f"{label} ({smi_line}): {wall!r} s, launches {launched}")
        missing = [k for k in need if launched[k] <= 0]
        if missing:
            raise AssertionError(f"{label}: kernels {missing} never "
                                 f"launched")
        return out

    sd = tool("15a step_decomp", lambda: step_decomp.run([]),
              ["fused_bounds_lanes"])
    say(f"15a step_decomp ({smi_line}): {json.dumps(sd)}")
    if not sd["pieces_sum_ms"] <= sd["step_ms"]:
        raise AssertionError(f"15a: the pieces ({sd['pieces_sum_ms']!r} "
                             f"ms) exceed a step ({sd['step_ms']!r} ms)")
    def micro():
        try:
            return micro_step.run([])
        except SystemExit as exc:
            # The drain guard: at the JAX defaults the pool may drain at or
            # before --steps; then the refusal names the largest clean
            # --steps, and the tool runs there.
            msg = str(exc)
            if "pool drains at step" not in msg:
                raise
            steps = msg.rsplit("--steps <= ", 1)[1]
            say(f"15b micro_step at its defaults refused: {msg}; again at "
                f"--steps {steps}")
            return micro_step.run(["--steps", steps])

    ms_ = tool("15b micro_step", micro, ["fused_bounds_lanes"])
    say(f"15b micro_step ({smi_line}): {json.dumps(ms_)}")
    if not ms_["kernel_ms_per_step"] <= ms_["pooled_ms_per_step"]:
        raise AssertionError("15b: the bare kernel exceeds a pooled step")
    rows = tool("15c mxu_experiment", lambda: mxu_experiment.run([]),
                ["nn_min"])
    for r in rows:
        say(f"15c mxu_experiment Q {r['q']} x P {r['p']} {r['mode']} "
            f"({smi_line}): {r['wall_ms']!r} ms, {r['mq_per_s']!r} Mq/s, "
            f"{r['tops_9op']!r} Top/s (9 ops a pair), max |d2 - vpu| "
            f"{r['max_abs_err']!r}")
    mp = tool("15d minplus_experiment", lambda: minplus_experiment.run([]),
              ["minplus_1d"])
    say(f"15d minplus_experiment ({smi_line}): {json.dumps(mp)}")
    if not (mp["f64_check"]["ok"] and mp["aligned"]["bits_equal"]
            and mp["field_build"]["fields_equal"]):
        raise AssertionError("15d: the f64 gate, the aligned bits or the "
                             "fields failed")
    for outer in ("host", "device"):
        # The device loop once: it repeats the host loop's hard search.
        flags = ["--pair", "synth", "--runs", "2" if outer == "host" else "1"]
        if outer == "device":
            flags.append("--device-outer")
        lines = tool(f"15e hard_pairs {outer}",
                     lambda: hard_pairs.run(flags),
                     ["nn_argmin", "nn_min", "fused_bounds_lanes_trimmed"])
        for ln in lines:
            say(f"15e hard_pairs {outer} run {ln['run']} ({smi_line}): "
                f"{json.dumps(ln)}")
            hard = (ln["seed_sse"] > ln["sse_threshold"]
                    and ln["rotation_children"] > 0
                    and ln["nodes"] > trimmed_nodes)
            # The pose gate on the certified pose's basin (phase 11's
            # rule): the engine's final ICP stops at icp_convergence_final,
            # short of the trimmed optimum.  The stand-in's planes leave no
            # other basin within sse_threshold (workloads.hard_synth), so
            # a certificate of another basin is a fault of the search.
            right = (ln["basin_r_err"] < 5e-3
                     and ln["basin_t_err_span"] < 5e-3)
            if not (ln["certified"] and right and hard):
                raise AssertionError(
                    f"15e hard_pairs {outer}: certified {ln['certified']}, "
                    f"basin R err {ln['basin_r_err']!r}, t err/span "
                    f"{ln['basin_t_err_span']!r}, seed sse "
                    f"{ln['seed_sse']!r} > {ln['sse_threshold']!r}, "
                    f"rotation_children {ln['rotation_children']}, nodes "
                    f"{ln['nodes']} > {trimmed_nodes} (phase 5's trimmed "
                    f"search-only)")
    for mode in ("ragged", "fallback"):
        lines = tool(
            f"15f serving_experiment {mode}",
            lambda: serving_experiment.run(["--mode", mode, "--runs", "2"]),
            ["nn_argmin", "nn_min"] + (["fused_bounds_lanes_trimmed"]
                                       if mode == "fallback" else []))
        for ln in lines:
            say(f"15f serving_experiment {mode} run {ln['run']} "
                f"({smi_line}): {ln['pairs']} pairs in {ln['wall_s']!r} s, "
                f"{ln['pairs_per_s']!r} pairs/s, {ln['certified']} "
                f"certified, {ln['fallbacks']} fallbacks, "
                f"{ln['exact_recoveries']} exact recoveries, seeding "
                f"{ln['seed_seconds']!r} s, fallbacks "
                f"{ln['fallback_seconds']!r} s")
            if ln["certified"] != ln["pairs"]:
                raise AssertionError(f"15f {mode}: {ln['certified']} of "
                                     f"{ln['pairs']} pairs certified")
            if mode == "fallback" and ln["fallbacks"] < 1:
                raise AssertionError("15f fallback: no pair took the "
                                     "fallback")
    rows = rec.check()
    held("phase 15", rows, smi_line,
         need=[k for k in kc.RECORDED if k != "fused_bounds"])
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA GPU", file=sys.stderr)
        return 1

    from fgoicp_tpu_torch import register
    from fgoicp_tpu_torch.kernels import build
    from fgoicp_tpu_torch.utils import trace

    # Phase 1: the card, the versions, the kernel build.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    say(smi_line)  # name, power limit
    say(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.time()
    lib = build.load()
    say(f"kernel build: {time.time() - t0:.3f} s ({lib._name})")

    # Phase 2: the kernel gate's full grid.
    t0 = time.time()
    ok, _, kernels = kc.run_check("full", "cuda")   # rows on stderr
    if not ok:
        bad = next(r for r in kernels if not r["ok"])
        raise AssertionError(f"kernel_check: {kc.describe(bad)}")
    say(f"kernel_check --grid full ({smi_line}): ok, {len(kernels)} rows in "
        f"{time.time() - t0!r} s")
    torch.cuda.empty_cache()

    # The smoke pair: seed-0 Lissajous cloud of 24,000 points cut into an
    # 18,000-point target and a 3,000-point source moved by a known pose;
    # and the trimmed phase's partial-overlap pair.
    pair = workloads.smoke_pair()
    trim_pair = workloads.trimmed_pair()
    serving = workloads.serving_data()
    dev = torch.device("cuda")
    WORK.mkdir(parents=True, exist_ok=True)
    cfg, pct_in, pcs_in = write_config(
        "smoke", pair[0], pair[1], "mse_threshold = 1e-3")
    tcfg, tpct_in, tpcs_in = write_config(
        "trimmed", trim_pair[0], trim_pair[1],
        "mse_threshold = 1e-3\ntrim = true\ntrim_fraction = 0.3")

    # Phases 3 to 7: the main paths through register(Config) and GoICP,
    # their cold runs under the recorder (`rec`) through phase 9.
    rec = kc.Recorder()

    def drive(label, cfg, pct_in, pcs_in, truth, record=None, **engine):
        """Cold then warm register() (the cold run recorded under `record`
        when given); returns each run's launches."""
        for key, value in engine.items():
            setattr(cfg.engine, key, value)
        out = {}
        for run in ("cold", "warm"):
            snap = snapshot()
            t_run = time.time()
            with (rec.record(record) if record and run == "cold"
                  else contextlib.nullcontext()):
                model, R, t = register(cfg, pct_in, pcs_in, device="cuda")
            torch.cuda.synchronize()
            wall = time.time() - t_run
            launched, nn_shapes = since(snap)
            host_reads = trace.requests()[-1].host_reads
            r_err, t_err = pose_errors(R, t, truth)
            s = model.stats
            say(f"{label} {run}: wall {wall!r} s (register), run "
                f"{s.wall_seconds!r} s, best_sse {model.best_sse!r}, gap "
                f"{model.last_certified_gap!r} <= {model.sse_threshold!r}, "
                f"R err {r_err!r}, t err/span {t_err!r}, translation_nodes "
                f"{s.translation_nodes}, rotation_children "
                f"{s.rotation_children}, outer_steps {s.outer_steps}, "
                f"inner_loop_steps {s.inner_loop_steps}, icp_runs "
                f"{s.icp_runs}, host reads {host_reads}, "
                f"launches {launched}, NN launches by shape {nn_shapes}")
            check_result(label, model, R, t, r_err, t_err)
            out[run] = dict(model=model, launched=launched, wall=wall,
                            host_reads=host_reads)
        return out

    def require(label, runs, names, nodes=True):
        for run in ("cold", "warm"):
            if nodes and runs[run]["model"].stats.translation_nodes <= 0:
                raise AssertionError(f"{label}: no translation node bounded")
            missing = [k for k in names if runs[run]["launched"][k] <= 0]
            if missing:
                raise AssertionError(f"{label} {run}: kernels {missing} "
                                     f"never launched on the main path")

    default = drive("default", cfg, pct_in, pcs_in, pair, "3 default",
                    icp_multi_start=True)
    require("default", default,
            ["farthest_point_sample", "icp_align", "icp_commit"], nodes=False)
    search = drive("search-only", cfg, pct_in, pcs_in, pair,
                   "4 search-only", icp_multi_start=False)
    require("search-only", search,
            ["nn_argmin", "nn_min", "fused_bounds_lanes",
             "farthest_point_sample", "icp_align", "icp_commit"])

    tdefault = drive("trimmed default", tcfg, tpct_in, tpcs_in, trim_pair,
                     "5 trimmed default", icp_multi_start=True)
    require("trimmed default", tdefault,
            ["farthest_point_sample", "icp_align", "icp_commit"], nodes=False)
    tsearch = drive("trimmed search-only", tcfg, tpct_in, tpcs_in, trim_pair,
                    "5 trimmed search-only", icp_multi_start=False)
    require("trimmed search-only", tsearch,
            ["nn_argmin", "nn_min", "fused_bounds_lanes_trimmed",
             "farthest_point_sample"])

    grouped = drive("grouped search-only", cfg, pct_in, pcs_in, pair,
                    "6 grouped search-only", icp_multi_start=False,
                    frontier_mode="grouped")
    require("grouped search-only", grouped,
            ["nn_argmin", "nn_min", "fused_bounds"])
    cfg.engine.frontier_mode = "pooled"

    lut_phase(torch, dev, pair, rec)
    # Phase 8 runs no user entry point: neither counted nor recorded.
    bunny_field_phase(torch, dev)
    srv = serving_phase(torch, dev, serving, rec, smi_line)
    # Every launch shape of phases 3 to 9 against the plain versions.
    recorded = rec.check()
    held("phases 3-9", recorded, smi_line, need=kc.RECORDED)
    kernels += recorded
    torch.cuda.empty_cache()

    # Phase 10: the device outer loop, its checkpoints and its overflow.
    dsearch = drive("device search-only", cfg, pct_in, pcs_in, pair,
                    icp_multi_start=False, outer_mode="device")
    require("device search-only", dsearch,
            ["nn_argmin", "nn_min", "fused_bounds_lanes"])
    compare_modes("device search-only", dsearch, search, smi_line)
    tdsearch = drive("trimmed device search-only", tcfg, tpct_in, tpcs_in,
                     trim_pair, icp_multi_start=False, outer_mode="device")
    require("trimmed device search-only", tdsearch,
            ["nn_argmin", "nn_min", "fused_bounds_lanes_trimmed"])
    compare_modes("trimmed device search-only", tdsearch, tsearch, smi_line)
    cfg.engine.outer_mode = tcfg.engine.outer_mode = "host"
    host_model = search["warm"]["model"]
    checkpoint_phase(torch, dev, pair, host_model.best_sse,
                     host_model.stats.outer_steps)
    many = overflow_phase(torch, dev, pair, host_model.best_sse)

    # Phase 11: the multi-host outer BnB, threads and processes.
    multihost_phase(torch, dev, pair, many, smi_line)

    # Phase 12: the device mesh, gloo processes sharing this card.
    served = srv.register(serving["sources"])
    refs = dict(smoke=search, grouped=grouped, trimmed=tsearch,
                device=dsearch)
    kernels += mesh_phase(
        {k: r["warm"]["model"] for k, r in refs.items()},
        {k: r["warm"]["wall"] for k, r in refs.items()}, served, serving,
        smi_line)

    # Phase 13: hosts on meshes, gloo processes sharing this card.
    kernels += hostmesh_phase(many, smi_line)

    # Phase 14: the merge update and the CLI's --profile / --debug-nans.
    merge_phase(drive, require, cfg, pct_in, pcs_in, pair,
                {"host": search, "device": dsearch}, smi_line)
    cli_phase(smi_line)

    # Phase 15: the experiment tools.
    kernels += tools_phase(
        torch, tsearch["warm"]["model"].stats.translation_nodes, smi_line)

    if "--profile" in sys.argv[1:]:
        profile_run(torch, register, "trimmed search-only", tcfg, tpct_in,
                    tpcs_in, "bounds_lanes_trimmed_kernel",
                    icp_multi_start=False)
        profile_run(torch, register, "search-only", cfg, pct_in, pcs_in,
                    "bounds_lanes_kernel", icp_multi_start=False,
                    frontier_mode="pooled")
        profile_run(torch, register, "grouped search-only", cfg, pct_in,
                    pcs_in, "bounds_grid_kernel", icp_multi_start=False,
                    frontier_mode="grouped")
        profile_run(torch, register, "device search-only", cfg, pct_in,
                    pcs_in, "bounds_lanes_kernel", icp_multi_start=False,
                    frontier_mode="pooled", outer_mode="device")
        profile_calls(torch, "serving 9a", lambda: srv.register(
            serving["sources"]), "nn_kernel")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def profile_run(torch, register, label, cfg, pct_in, pcs_in, kernel,
                **engine):
    """One warm register() of a phase under torch.profiler (profile_calls)."""
    for key, value in engine.items():
        setattr(cfg.engine, key, value)
    profile_calls(torch, label, lambda: register(cfg, pct_in, pcs_in,
                                                 device="cuda"), kernel)


def profile_calls(torch, label, call, kernel):
    """One warm call() under torch.profiler, after one untraced call:
    device time by kernel, the device busy share, the launch count, and the
    device time and launches of the named kernel."""
    from torch.profiler import ProfilerActivity, profile
    call()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # Timed inside the block: leaving it post-processes the trace.
        t_run = time.time()
        call()
        torch.cuda.synchronize()
        wall = time.time() - t_run
    averages = prof.key_averages()
    events = [e for e in averages
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    busy_us = sum(e.self_device_time_total for e in events)
    n_launch = sum(e.count for e in averages if e.key in LAUNCH_KEYS)
    mine = [e for e in events if kernel in e.key]
    say(f"profile {label} (warm): wall {wall!r} s, device busy "
        f"{busy_us / 1e6!r} s ({100 * busy_us / 1e6 / wall!r} %), kernel "
        f"launches {n_launch}; {kernel}: "
        f"{sum(e.self_device_time_total for e in mine) / 1e3!r} ms of device "
        f"time in {sum(e.count for e in mine)} launches")
    say(averages.table(sort_by="self_device_time_total", row_limit=15,
                       max_name_column_width=60))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-worker"]:
        sys.exit(multihost_worker(int(sys.argv[2]), sys.argv[3],
                                  sys.argv[4]))
    if sys.argv[1:2] == ["--hostmesh-worker"]:
        sys.exit(hostmesh_worker(sys.argv[2], int(sys.argv[3]),
                                 int(sys.argv[4]), int(sys.argv[5]),
                                 sys.argv[6], sys.argv[7]))
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(mesh_worker(sys.argv[2], int(sys.argv[3]),
                             int(sys.argv[4]), int(sys.argv[5]),
                             sys.argv[6], sys.argv[7]))
    sys.exit(main())
