#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`fgoicp_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--profile]

Phases, each failing the run (nonzero exit) on its first failed check:
  1. print the GPU's name and power limit (nvidia-smi) and the torch / CUDA
     versions; build the CUDA kernels from `fgoicp_tpu_torch/csrc` and print
     the build seconds;
  2. compare each kernel with its plain torch version on the card at the
     main paths' shapes (nn_argmin / nn_min d2 and idx bit-equal, also at
     M in {1, 127, 129} x T in {1, 1023, 1025, 2049}, on a duplicated grid
     whose tied copies fall in different target slices and where every d2
     is above BIG, with more than one slice planned at the polish shape;
     bounds rtol 2e-4 / atol 2e-5 and lb <= ub) and time both with CUDA
     events, beside the kernel's bound (operations or bytes at the H100's
     published peaks; for the NN kernels also the instruction-issue
     ceiling), one PyTorch library call where one computes the same function,
     and, for the trimmed lanes, the unfused path (nearest-proxy kernel plus
     the torch bisection bracket); the three box-pruned bound kernels
     (`fused_bounds_lanes`, `fused_bounds`, `fused_bounds_lanes_trimmed`)
     also bit-equal to their plain versions with one-hot point weights
     (each node's sum is then one term; the trimmed kernel at n_drop 0,
     where lb and ub are functions of that term) for every source point at
     the main paths' shapes and at edge shapes (P in {1, 31, 33, 1024, 2049} x ns in {1, 129,
     3000}, points on box faces and corners, duplicated proxies split
     across buckets, every d2 above BIG), with the (point, proxy) pairs and
     (point, box) tests they evaluate from their counters, which set their
     bound (the full scan's beside it), the issue ceiling of that work, and
     their time given the backend's buckets and the source order, as GoICP
     gives them, and given a bare proxies tensor; and `minplus_1d`
     bit-equal to its plain version on seeded, constant, negative and
     few-valued lines and on the three passes of the EDT of the smoke
     target's field at lut_resolution 0.002, timed per full pass, with the
     (line, i, j) triples it evaluates and the (warp, chunk) pairs it
     stages from its counters, which set its bound (all triples' beside
     it; library none: no PyTorch call computes a min-plus product); and
     the serving shapes of phase 9a (seeding nn_argmin 983,040 x 4,096 on
     the target's 4,096-point coreset, the exact rescore nn_min 3,840,000 x
     6,000, the polish nn_argmin 256,000 x 6,000, the covering radius
     nn_min 6,000 x 4,096: bit-equal, each with its slice plan, and no
     torch.cdist where its [M, T] matrix would hold 2^31 elements or more)
     and fused_bounds_lanes at a serving fallback's shape (2,048 source
     clusters against the shared 1,024-point coreset); and
     farthest_point_sample's indices equal to the plain loop's at the main
     paths' FPS shapes (17,953 -> 1,024, 3,037 -> 1,024, 8,000 -> 2,048,
     6,000 -> 4,096 and 6,000 -> 1,024), its ms a call, us a step and
     latency bound (k - 1 steps at its step at n = 1), and the kernel
     launches of a warm bunny-size GoICP construction; and the ICP
     iteration's kernels (icp_align, icp_commit) against their plain
     versions at the main paths' ICP shapes and thresholds (15 x 1,024 on
     1,024, 1 x 3,037 on 17,953, 480 x 2,048 on 4,096, 32 x 8,000 on
     6,000): from the plain loop's state at each iteration until its lanes
     stop, R, t, last_R, last_t and the moved points within 2e-5, the SSE
     within rtol 1e-4, last_sse and the lanes already done bit for bit,
     done and running equal but within rounding of the threshold, and the
     guard must fire; each one's ms a call and device time a launch
     (profiler), and the host's ms an iteration (align, NN, commit, one
     read) on the kernels and on the plain versions;
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
     every pair certified and recovered (R < 5e-3, t < 2e-3 x span);
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
     keeps the arguments of every distinct shape at which its cold runs
     launch nn_argmin, nn_min, fused_bounds_lanes or fused_bounds, and holds
     each against the plain version (NN bit for bit, bounds at rtol 2e-4 /
     atol 2e-5), with its time, bound and library time (for the pruned
     bound kernels the bound of the work their counters report, the full
     scan's beside it); each of the four must be held at some shape.
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
     its cold run's launch shapes against the plain versions (minplus_1d
     bit for bit, with the triples its counters report);
 14. the rest of the slice: search-only and device search-only with
     pool_update = "merge" (certified, best_sse within sse_threshold of
     phases 4 and 10a, nodes and steps beside sort's); the CLI on the smoke
     pair three times at once, plain, --debug-nans (the same result TOML)
     and --profile DIR (a Chrome trace naming nn_kernel and
     bounds_lanes_kernel); `python -m fgoicp_tpu_torch.scripts.kernel_check
     --grid reduced` (every row passes);
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
     version afterwards (the plain version once a shape), with its time,
     bound and library time.
Every launch counter is set to 0 just before each path and read just
after; the phase lines also give the NN kernels' launches per (M, T).  With
--profile, one warm run each of trimmed search-only, search-only, grouped
search-only, device search-only and a 9a batch is then traced with
torch.profiler (device time
by kernel, launch count, busy share, and the device time and launches of
the phase's bound kernel, for serving the NN kernel).  Every time and rate
of phase 9 is printed beside the card's name and power limit.

Earlier lines report walls, node counts, launch counts and a JSON line of
the kernels; the last line is {"ok": true, "device": {...}}.  Needs a CUDA
GPU (exits nonzero without one) and imports nothing of JAX.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
# Published H100 SXM peaks (NVIDIA data sheet, 700 W): float32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# The H100 SXM's instruction-issue rate: one warp instruction per clock on
# each of 4 x 132 schedulers at the 1.98 GHz boost clock.  With --fmad=false
# every sub, mul, add and min of a distance issues on its own: the NN
# kernels issue about 9.25 (nn_min) and 9.75 (nn_argmin) instructions per
# (query, target) pair, which sets their issue ceiling below.
INSTR_RATE = 132 * 4 * 32 * 1.98e9
NN_INSTRS = {"nn_min": 9.25, "nn_argmin": 9.75}
# The untrimmed bound kernels' box-pruned search (csrc/bounds_terms.cuh):
# 9.25 issues per (point, proxy) pair evaluated, as nn_min, and about 19 per
# (point, box) test (6 sub, 6 max, 3 mul, 2 add, a compare and the vote;
# counted from the source).  Their bound counts the flops of that work: 8 a
# pair (3 sub, 3 mul, 2 add) and 17 a box test (6 sub, 6 max, 3 mul, 2 add),
# the compare and the min left out of both.
PAIR_INSTRS, BOX_INSTRS = 9.25, 19.0
PAIR_FLOPS, BOX_FLOPS = 8.0, 17.0
# The reference's bunny distance-field resolution (configs/bunny.toml), at
# which the JAX bench runs the LUT backend (bench.py bunny_lut_res0.002).
LUT_RESOLUTION = 0.002
# The real bunny field's dims at that resolution (BASELINE.md), which
# phase 8 reproduces with a synthetic cloud.
BUNNY_FIELD_DIMS = (960, 946, 741)
# The vertex count of the skull scan of the JAX bench's serving lines
# (data_skull.ply), which phase 9's synthetic stand-in takes.
SKULL_POINTS = 98359
# Phase 9b's mse threshold, by the JAX bench's rule (bench.py:297-311):
# above every partial view's mse at its true pose (the target subsample's
# NN floor) and below the mse of every view that seeding leaves in a wrong
# basin, so that a certificate is a true pose and the wrong-basin views
# must take the fallback.  Phase 9b prints both and checks the rule.
# Measured (NVIDIA H100 80GB HBM3, 700 W): floors 4.68e-6 to 1.43e-5, two
# views seeded into wrong basins at 7.96e-5 and 1.03e-2; VIEW_MSE is the
# geometric mean of 1.43e-5 and 7.96e-5.
VIEW_MSE = 4.3e-5
# The serving cloud's noise, a quarter of the smoke pair's: at 0.01 the
# floors reached 9.53e-5 against a wrong basin at 1.38e-4, and at VIEW_MSE
# 1.2e-4 between them a fallback's BnB ended with its gap open.
SERVING_NOISE = 0.0025


def curve(rng, s, noise=0.01):
    """Points of the seeded asymmetric 3D Lissajous curve at parameters s
    (the JAX package's test generator, tests/test_goicp.py::_surface_cloud)."""
    pts = np.stack([np.cos(s), 0.7 * np.sin(2.0 * s),
                    0.4 * np.sin(3.0 * s + 0.5)], axis=1)
    pts = pts + rng.normal(scale=noise, size=(len(s), 3))
    return pts.astype(np.float32)


def surface_cloud(rng, n, noise=0.01):
    return curve(rng, rng.uniform(0.0, 4.5, size=(n,)), noise)


def pose(span, angle=1.8):
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return R, np.array([0.11, -0.07, 0.05], np.float32) * span


def known_transform_pair(cloud, n_target, n_source, seed=5, angle=1.8):
    """Target subsample + a source subsample moved by a known (R, t), with
    R @ source + t on the target (bench.py::_known_transform_pair)."""
    rng = np.random.default_rng(seed)
    cloud = np.asarray(cloud, np.float32)
    ti = rng.choice(len(cloud), size=n_target, replace=False)
    si = rng.choice(len(cloud), size=n_source, replace=False)
    span = float(np.ptp(cloud, axis=0).max())
    R, t = pose(span, angle)
    pcs = (cloud[si] - t) @ R
    return cloud[ti], pcs, R, t, span


def partial_overlap_pair(n_target=20000, n_source=10000, seed=3,
                         noise=0.005):
    """A partial-overlap scan pair at the scale of the JAX bench's
    bunny_scans_000_045_trimmed line (20k / 10k points): the target samples
    the curve over s in [0, 3.7], the source over [0.95, 4.5] (22.5 % of it
    beyond the target's part), independently, with noise of about 0.2 % of
    the span, moved by a known pose."""
    rng = np.random.default_rng(seed)
    pct = curve(rng, rng.uniform(0.0, 3.7, size=(n_target,)), noise)
    src = curve(rng, rng.uniform(0.95, 4.5, size=(n_source,)), noise)
    span = float(np.ptp(np.concatenate([pct, src]), axis=0).max())
    R, t = pose(span)
    return pct, (src - t) @ R, R, t, span


def random_rotation(rng):
    """A uniform random rotation by QR (bench.py's serving lines)."""
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    R = (q * np.sign(np.diag(q))[None, :]).astype(np.float32)
    if np.linalg.det(R) < 0:
        R[:, 0] *= -1
    return R


def turn(rng, angle):
    """A rotation by `angle` about a uniform random axis (Rodrigues)."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(angle) * k
            + (1 - np.cos(angle)) * k @ k).astype(np.float32)


def serving_data():
    """Phase 9's inputs, a stand-in for the JAX bench's serving lines
    (bench.py::bench_serving), whose skull scan is not in the repository: a
    seeded cloud of SKULL_POINTS points of the smoke's curve, a 6,000-point
    target drawn from it, 32 sources of 8,000 points at uniform random
    rotations and translations up to +-0.25 span (9a), and 8 ragged half-space
    partial views of at most 6,000 points at random poses (9b).  Noise
    SERVING_NOISE."""
    cloud = surface_cloud(np.random.default_rng(9), SKULL_POINTS,
                          noise=SERVING_NOISE)
    rng = np.random.default_rng(11)
    pct = cloud[rng.choice(len(cloud), size=6000, replace=False)]
    span = float(np.ptp(cloud, axis=0).max())

    def moved(points, rng):
        R = random_rotation(rng)
        t = rng.uniform(-0.25, 0.25, size=3).astype(np.float32) * span
        return (points - t) @ R, (R, t)

    batch = [moved(cloud[rng.choice(len(cloud), size=8000, replace=False)],
                   rng) for _ in range(32)]
    rng2 = np.random.default_rng(23)
    mu = cloud.mean(axis=0)
    views = []
    for _ in range(8):
        nrm = rng2.normal(size=3)
        nrm /= np.linalg.norm(nrm)
        part = cloud[(cloud - mu) @ nrm > 0]
        # Ragged sizes (the weighted path): 3,000 to 6,000 points.
        n = min(len(part), int(rng2.integers(3000, 6001)))
        views.append(moved(part[rng2.choice(len(part), size=n,
                                            replace=False)], rng2))
    return dict(pct=pct, span=span,
                sources=np.stack([s for s, _ in batch]),
                truth=[p for _, p in batch], views=[v for v, _ in views],
                view_truth=[p for _, p in views])


def say(msg):
    print(msg, flush=True)


def cuda_ms(torch, fn, reps):
    """Mean milliseconds per call on the card: warm-up, then CUDA events
    around `reps` calls after a synchronize."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def timed_once(torch, fn):
    """(fn(), its milliseconds on the card by CUDA events), one call."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def bound(flops, nbytes):
    """(ms, "operations" | "bytes"): the least time the card could take,
    the larger of flops at the f32 peak and bytes at the HBM peak."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def report(name, shape, err, ms, plain_ms, flops, nbytes, library_ms=None):
    """Print one kernel case (errors, times, bound) and return it as the
    fields of its JSON row."""
    bound_ms, bound_by = bound(flops, nbytes)
    say(f"kernel {name} [{shape}]: max_abs_err {err!r}, kernel {ms!r} ms, "
        f"plain {plain_ms!r} ms, bound {bound_ms!r} ms ({bound_by}), "
        f"library {library_ms!r} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def row(name, source, replaces, case):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=0, **case)


def check_bounds(torch, name, got, want):
    """Kernel (lb, ub) against the plain version's: rtol 2e-4 / atol 2e-5
    and lb <= ub on every node.  Returns the max abs error."""
    torch.cuda.synchronize()
    for nm, k, p in (("lb", got[0], want[0]), ("ub", got[1], want[1])):
        if not bool(torch.all(torch.isfinite(k))):
            raise AssertionError(f"{name} {nm}: non-finite values")
        if not torch.allclose(k, p, rtol=2e-4, atol=2e-5):
            raise AssertionError(
                f"{name} {nm}: max abs err {float((k - p).abs().max())} "
                f"beyond rtol 2e-4 / atol 2e-5")
    if not bool(torch.all(got[0] <= got[1] + 1e-5)):
        raise AssertionError(f"{name}: lb > ub on some node")
    return max(float((got[0] - want[0]).abs().max()),
               float((got[1] - want[1]).abs().max()))


def nn_equal(torch, name, out_k, out_p):
    """The NN kernel's d2 (and idx) against its plain version's, bit for
    bit: the kernel rounds every operation as the plain version does and
    its merge across target slices is exact.  Returns the max abs error."""
    torch.cuda.synchronize()
    out_k = out_k if isinstance(out_k, tuple) else (out_k,)
    out_p = out_p if isinstance(out_p, tuple) else (out_p,)
    for nm, k, p in zip(("d2", "idx"), out_k, out_p):
        if not torch.equal(k, p):
            n_bad = int((k != p).sum())
            raise AssertionError(f"{name}: {n_bad} {nm} values differ from "
                                 f"the plain version")
    return float((out_k[0] - out_p[0]).abs().max()) if out_k[0].numel() \
        else 0.0


def nn_edges(torch, dev):
    """Phase 2, the NN kernels at edge shapes against their plain versions,
    bit for bit: M in {1, 127, 129} x T in {1, 1023, 1025, 2049}; a 16^3
    grid listed 3 times (12,288 targets, copies 4,096 apart in different
    target slices) queried at its nodes and at midpoints (exact ties
    everywhere; exact hits must take the first copy); and queries 3.5e5 away
    (every d2 above BIG: (BIG, 0))."""
    from fgoicp_tpu_torch.ops import cuda_nn

    rng = np.random.default_rng(17)
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                    device=dev)

    def both(label, q, p):
        out = cuda_nn.nn_argmin(q, p)
        nn_equal(torch, f"nn_argmin {label}", out,
                 cuda_nn.nn_argmin_plain(q, p))
        nn_equal(torch, f"nn_min {label}", cuda_nn.nn_min(q, p),
                 cuda_nn.nn_min_plain(q, p))
        return out

    for m in (1, 127, 129):
        for t in (1, 1023, 1025, 2049):
            both(f"[{m}x{t}]", f32(rng.uniform(-1, 1, (m, 3))),
                 f32(rng.uniform(-1, 1, (t, 3))))
    grid = np.mgrid[0:16, 0:16, 0:16].reshape(3, -1).T.astype(np.float32)
    pts, qs = f32(np.concatenate([grid] * 3)), f32(np.concatenate(
        [grid, grid + np.float32(0.5), grid + np.float32([0.5, 0, 0])]))
    splits, chunk = cuda_nn._plan(dev, qs.shape[0], pts.shape[0])
    if splits < 3 or chunk > grid.shape[0]:
        raise AssertionError(f"duplicated grid: plan {splits} x {chunk} "
                             f"keeps tied copies in one slice")
    d2, idx = both("duplicated grid", qs, pts)
    n = grid.shape[0]
    if not (torch.equal(idx[:n].cpu(), torch.arange(n, dtype=torch.int32))
            and int(idx.max()) < n and not bool(d2[:n].any())):
        raise AssertionError("duplicated grid: exact hits not on the first "
                             "copy")
    far_q = f32(rng.uniform(-1, 1, (700, 3)) - 2e5)
    d2, idx = both("far away", far_q, f32(rng.uniform(-1, 1, (5000, 3))))
    if not (bool(torch.all(d2 == cuda_nn.BIG)) and not bool(idx.any())):
        raise AssertionError("far away: not (BIG, 0)")
    say(f"kernel nn_argmin / nn_min edge cases: [1, 127, 129] x [1, 1023, "
        f"1025, 2049], duplicated grid {tuple(qs.shape)} x "
        f"{tuple(pts.shape)} in {splits} slices of {chunk}, far away "
        f"(BIG, 0): bit-equal to the plain versions")


def plain_terms(torch, base, gids, t_lanes, proxies, gam_ub, gam_lb,
                gam_t_lanes, slack):
    """The plain version's per-point terms (lt, ut) [nodes, ns] with unit
    weights.  With one-hot weights at point j its sums are column j bit for
    bit: every other term is +0."""
    from fgoicp_tpu_torch.ops import cuda_bounds
    ones = torch.ones(base.shape[1], dtype=torch.float32, device=base.device)
    parts = list(cuda_bounds._lane_terms_plain(
        base, gids, t_lanes, proxies, gam_ub, gam_lb, gam_t_lanes, slack,
        ones))
    return (torch.cat([lt for _, _, lt in parts]),
            torch.cat([ut for _, ut, _ in parts]))


def one_hot_terms(torch, name, kernel, terms, points=None, plain=None):
    """The bound kernel's (lb, ub) with one-hot point weights at each source
    point j of `points` (default every point), bit for bit against column j
    of the plain version's terms (lt, ut) [nodes, ns] (`plain_terms`): each
    node's sum is then that single term, computed with the same rounding,
    so any difference is a wrong nearest-proxy value.  When plain is given,
    the plain version's own one-hot sums are held to those columns at
    `picks_of(ns)`.  kernel(w) / plain(w) take the weights [ns]."""
    lt, ut = terms
    ns = lt.shape[1]
    points = list(range(ns)) if points is None else list(points)
    got_lb = torch.empty((len(points), lt.shape[0]), device=lt.device)
    got_ub = torch.empty_like(got_lb)
    w1 = torch.zeros(ns, dtype=torch.float32, device=lt.device)
    for row, j in enumerate(points):
        w1.zero_()
        w1[j] = 1.0
        lb, ub = kernel(w1)
        got_lb[row], got_ub[row] = lb.reshape(-1), ub.reshape(-1)
    for j in (picks_of(ns) if plain is not None else ()):
        w1.zero_()
        w1[j] = 1.0
        lb, ub = plain(w1)
        if not (torch.equal(lb.reshape(-1), lt[:, j])
                and torch.equal(ub.reshape(-1), ut[:, j])):
            raise AssertionError(f"{name}: the plain version's one-hot sums "
                                 f"at point {j} are not its terms")
    for nm, k, p in (("lb", got_lb, lt.T[points]), ("ub", got_ub,
                                                    ut.T[points])):
        if not torch.equal(k, p):
            bad = [points[r] for r in
                   (k != p).any(dim=1).nonzero()[:, 0].tolist()]
            raise AssertionError(f"{name}: one-hot {nm} differs from the "
                                 f"plain version at {len(bad)} points, "
                                 f"e.g. {bad[:8]}")


def trimmed_one_hot(torch, terms):
    """What the trimmed lane kernel returns at n_drop 0 with one-hot
    weights at point j, from the plain version's terms (lt, ut) [nodes, ns]
    (`plain_terms`): its bisection sees one term x and zeros, so lo becomes
    0.5 * (lo + x) 26 times and hi stays x; ub ("under", threshold hi) is x
    itself and lb ("over", threshold lo) is x where x <= lo, else lo.
    Returned as (lb, ub) columns for `one_hot_terms`."""
    from fgoicp_tpu_torch.ops import cuda_bounds
    lt, ut = terms
    lo = torch.zeros_like(lt)
    for _ in range(cuda_bounds.BISECT_ITERS):
        lo = 0.5 * (lo + lt)
    return torch.where(lt <= lo, lt, lo), ut


def picks_of(ns, n=6):
    """Point indices for one-hot checks: the first, the last and n drawn
    from their own seed (the other inputs' draws stay as they were)."""
    rng = np.random.default_rng(ns)
    return sorted({0, ns - 1, *rng.integers(0, ns, size=n).tolist()})


def pair_counts(torch, launch):
    """(pairs evaluated, box tests) of one kernel launch, from the kernel's
    counters: launch(counts) runs it with an int64 [2] counter tensor."""
    counts = torch.zeros(2, dtype=torch.int64, device="cuda")
    launch(counts)
    torch.cuda.synchronize()
    return [int(v) for v in counts.cpu()]


def bounds_edges(torch, dev):
    """Phase 2, the three pruned bound kernels at edge shapes against their
    plain versions: lb / ub within rtol 2e-4 / atol 2e-5 with cluster-like
    weights (a 0/1 mask and n_drop 0.3 ns for the trimmed kernel), and bit
    for bit with one-hot weights (at every point given the proxies' buckets
    and the source order, at `picks_of` given a bare proxies tensor and no
    order; the trimmed kernel at n_drop 0, `trimmed_one_hot`), on 8 lanes
    of 2 groups and a 2 x 4 grid:
    P in {1, 31, 33, 1024, 2049} x ns in {1, 129, 3000} (seeded clouds);
    proxies on an 8^3 grid with queries on its nodes and face midpoints
    (points on box faces and corners); 33 copies of one proxy split across
    buckets; and every d2 above BIG."""
    from fgoicp_tpu_torch.ops import cuda_bounds

    rng = np.random.default_rng(19)
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                    device=dev)

    def check(label, src, proxies, t_l, rotate=True):
        ns = src.shape[0]
        c, s_ = np.cos(0.3), np.sin(0.3)
        R = np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1]], np.float32)
        base = f32(np.stack([src, src @ R.T if rotate else src]))
        prox = f32(proxies)
        gam_ub = f32(rng.uniform(0.0, 0.05, size=(2, ns)))
        gam_lb = gam_ub + f32(rng.uniform(0.0, 0.02, size=(2, ns)))
        w = f32(rng.integers(1, 6, size=(ns,)))
        gids = torch.as_tensor(np.arange(8) % 2, dtype=torch.int32,
                               device=dev)
        t_l, gam_t = f32(t_l), f32(rng.uniform(0.0, 0.1, size=(8,)))
        tc, gt = t_l.reshape(2, 4, 3), gam_t.reshape(2, 4)
        slack = float(np.float32(0.01))
        buckets = cuda_bounds.proxy_buckets(prox)
        order = cuda_bounds.source_order(f32(src))
        lanes = lambda wt, px=buckets, po=order: \
            cuda_bounds.fused_bounds_lanes(
                base, gids, t_l, px, gam_ub, gam_t, slack, point_weights=wt,
                gam_lb=gam_lb, point_order=po)
        lanes_p = lambda wt: cuda_bounds.fused_bounds_lanes_plain(
            base, gids, t_l, prox, gam_ub, gam_lb, gam_t, slack, wt)
        grid = lambda wt, px=buckets, po=order: cuda_bounds.fused_bounds(
            base, tc, px, gam_ub, gt, slack, point_weights=wt,
            gam_lb=gam_lb, point_order=po)
        grid_p = lambda wt: cuda_bounds.fused_bounds_plain(
            base, tc, prox, gam_ub, gam_lb, gt, slack, wt)
        mask = f32(rng.uniform(size=(ns,)) < 0.8)
        n_drop = int(round(0.3 * ns))
        # The trimmed kernel: weights given, n_drop 0 (one-hot); None, the
        # mask and n_drop.
        trim = lambda wt, px=buckets, po=order: \
            cuda_bounds.fused_bounds_lanes_trimmed(
                base, gids, t_l, px, gam_ub, gam_t, slack,
                n_drop if wt is None else 0,
                point_weights=mask if wt is None else wt, gam_lb=gam_lb,
                point_order=po)
        trim_p = lambda wt: cuda_bounds.fused_bounds_lanes_trimmed_plain(
            base, gids, t_l, prox, gam_ub, gam_lb, gam_t, slack,
            mask if wt is None else wt, n_drop if wt is None else 0)
        grid_ids = torch.arange(2, dtype=torch.int32,
                                device=dev).repeat_interleave(4)
        for name, k, p, ids, wts in (
                ("fused_bounds_lanes", lanes, lanes_p, gids, w),
                ("fused_bounds", grid, grid_p, grid_ids, w),
                ("fused_bounds_lanes_trimmed", trim, trim_p, gids, None)):
            check_bounds(torch, f"{name} {label}", k(wts), p(wts))
            terms = plain_terms(torch, base, ids, t_l, prox, gam_ub, gam_lb,
                                gam_t, slack)
            if k is trim:
                terms = trimmed_one_hot(torch, terms)
            one_hot_terms(torch, f"{name} {label}", k, terms, plain=p)
            one_hot_terms(torch, f"{name} {label} (bare proxies)",
                          lambda wt: k(wt, prox, None), terms,
                          picks_of(ns, 2))

    for n_prox in (1, 31, 33, 1024, 2049):
        for ns in (1, 129, 3000):
            check(f"[P{n_prox} ns{ns}]",
                  rng.uniform(-0.7, 0.7, size=(ns, 3)),
                  rng.uniform(-0.9, 0.9, size=(n_prox, 3)),
                  rng.uniform(-0.4, 0.4, size=(8, 3)))
    grid = np.mgrid[0:8, 0:8, 0:8].reshape(3, -1).T * np.float32(0.125)
    half = np.float32(0.0625)
    check("[grid nodes and faces]",
          np.concatenate([grid, grid + [half, 0, 0], grid + [half, half, 0]]),
          grid, np.repeat([[0, 0, 0], [0.125, 0, -0.125]], 4, axis=0),
          rotate=False)
    dup = np.array([[0.3, 0.1, -0.2]])
    check("[33 copies of one proxy]",
          np.concatenate([rng.uniform(-0.7, 0.7, size=(200, 3)),
                          np.repeat(dup, 20, axis=0)]),
          np.concatenate([rng.uniform(-0.9, 0.9, size=(100, 3)),
                          np.repeat(dup, 33, axis=0),
                          rng.uniform(-0.9, 0.9, size=(30, 3))]),
          rng.uniform(-0.05, 0.05, size=(8, 3)))
    check("[every d2 above BIG]", rng.uniform(-0.7, 0.7, size=(300, 3)) + 2e5,
          rng.uniform(-0.9, 0.9, size=(700, 3)),
          rng.uniform(-0.4, 0.4, size=(8, 3)))
    say("kernel fused_bounds_lanes / fused_bounds / fused_bounds_lanes_"
        "trimmed edge cases: P [1, 31, 33, "
        "1024, 2049] x ns [1, 129, 3000], grid nodes and faces, 33 copies "
        "of one proxy, every d2 above BIG: lb / ub within rtol 2e-4 / atol "
        "2e-5, one-hot weights bit-equal to the plain versions at every "
        "point (some given bare proxies)")


def compare_kernels(torch, pct, pcs, trim_pct, trim_src, serving):
    """Phase 2: every kernel against its plain version at main-path
    shapes, the serving shapes of phase 9a included.  Returns the JSON rows
    (launch counts filled in later)."""
    from fgoicp_tpu_torch.ops import bounds as bounds_ops
    from fgoicp_tpu_torch.ops import coreset as coreset_ops
    from fgoicp_tpu_torch.ops import cuda_bounds, cuda_nn
    from fgoicp_tpu_torch.ops import geometry as geo

    dev = pct.device
    rng = np.random.default_rng(11)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    proxy = coreset_ops.build(pct, size=1024, seed=0)
    prox = proxy.points.contiguous()
    n_prox = prox.shape[0]
    slack = float(proxy.eps)
    clusters = coreset_ops.build_weighted(pcs, size=1024, seed=2)
    # 16 search-ICP lanes of the 3,000-point source, as the seeding sweep.
    R16 = geo.quat_cube_to_matrix(f32(rng.uniform(-0.5, 0.5, size=(16, 3))))
    t16 = f32(rng.uniform(-0.1, 0.1, size=(16, 1, 3)))
    q48k = (torch.einsum("grc,nc->gnr", R16, pcs) + t16).reshape(-1, 3).contiguous()

    def nn_case(name, kernel, plain, queries, points, reps, plain_reps,
                library=True):
        err = nn_equal(torch, name, kernel(queries, points),
                       plain(queries, points))
        m, t = queries.shape[0], points.shape[0]
        splits, chunk = cuda_nn._plan(dev, m, t)
        ms = cuda_ms(torch, lambda: kernel(queries, points), reps)
        plain_ms = cuda_ms(torch, lambda: plain(queries, points), plain_reps)
        # The library yardstick: exact pairwise distances, then the min.
        reduce = (lambda d: torch.min(d, dim=1)) if name == "nn_argmin" \
            else (lambda d: torch.amin(d, dim=1))
        lib_ms = cuda_ms(torch, lambda: reduce(torch.cdist(
            queries, points, compute_mode="donot_use_mm_for_euclid_dist")),
            plain_reps) if library else None
        if not library:
            say(f"kernel {name} [{m}x{t}]: library refused (torch.cdist's "
                f"[M, T] matrix of {m * t} elements is not formed)")
        out_bytes = 4 * m * (2 if name == "nn_argmin" else 1)
        issue_ms = NN_INSTRS[name] * m * t / INSTR_RATE * 1e3
        say(f"kernel {name} [{m}x{t}]: {splits} target slices of {chunk} "
            f"({-(-m // cuda_nn.QUERY_TILE) * splits} blocks), issue "
            f"ceiling {issue_ms!r} ms")
        return report(name, f"{m}x{t}", err, ms, plain_ms, 8.0 * m * t,
                      12.0 * (m + t) + out_bytes, lib_ms)

    # The trimmed pair's proxies, and 16 search-ICP lanes of its source's
    # 2,048-point search subsample, as the engine draws them.
    trim_prox = coreset_ops.build(trim_pct, size=1024, seed=0).points
    sub = np.sort(np.random.default_rng(7).permutation(
        trim_src.shape[0])[:2048])
    q32k = (torch.einsum("grc,nc->gnr", R16,
                         trim_src[torch.from_numpy(sub).to(dev)])
            + t16).reshape(-1, 3).contiguous()
    argmin = (cuda_nn.nn_argmin, cuda_nn.nn_argmin_plain)
    nmin = (cuda_nn.nn_min, cuda_nn.nn_min_plain)
    # nn_argmin: search-ICP correspondences (16 x 3,000 against the 1,024
    # proxies), the polish (3,000 against the 18,000-point target), the
    # source against the proxies, the trimmed polish (10,000 against
    # 20,000) and the trimmed search-ICP lanes (16 x 2,048 against 1,024).
    a1 = nn_case("nn_argmin", *argmin, q48k, prox, 50, 10)
    if cuda_nn._plan(dev, pcs.shape[0], pct.shape[0])[0] <= 1:
        raise AssertionError("nn_argmin: one target slice planned at the "
                             "polish shape; the merge would not run")
    nn_case("nn_argmin", *argmin, pcs, pct, 50, 10)
    nn_case("nn_argmin", *argmin, pcs, prox, 50, 10)
    nn_case("nn_argmin", *argmin, trim_src, trim_pct, 50, 5)
    nn_case("nn_argmin", *argmin, q32k, trim_prox, 50, 10)
    # nn_min: the exact rescore (16 x 3,000 against 18,000), the proxy
    # covering radius (18,000 against 1,024), the trimmed one (20,000
    # against 1,024) and the trimmed rescore (16 x 10,000 against 20,000).
    m1 = nn_case("nn_min", *nmin, q48k, pct, 20, 3)
    nn_case("nn_min", *nmin, pct, prox, 50, 10)
    nn_case("nn_min", *nmin, trim_pct, trim_prox, 50, 10)
    q160k = (torch.einsum("grc,nc->gnr", R16, trim_src) + t16).reshape(
        -1, 3).contiguous()
    # No library time: torch.cdist refuses a 160,000 x 20,000 launch
    # (invalid configuration argument).
    nn_case("nn_min", *nmin, q160k, trim_pct, 10, 1, library=False)
    del q160k, q32k

    # The serving shapes: phase 9a's batch (32 pairs x 8,000 points against
    # the 6,000-point target) as _seed_pairs hands it to the kernels, 15
    # starts a pair, lane b * 15 + s; seeding on the 2,048-row subsample of
    # every source against the 4,096-point coreset of the centred target.
    sv_pct = f32(serving["pct"] - serving["pct"].mean(axis=0))
    sv_src = f32(serving["sources"])
    sv_src = sv_src - sv_src.mean(dim=1, keepdim=True)
    b_sv, ns_sv = sv_src.shape[:2]
    cover = coreset_ops.build(sv_pct, size=4096, seed=0).points.contiguous()
    starts = f32(geo.multi_start_rotations())
    R_lanes = starts.repeat(b_sv, 1, 1)
    seed_lanes = lambda src: torch.einsum(
        "grc,gnc->gnr", R_lanes, src.repeat_interleave(len(starts), 0)
    ).reshape(-1, 3).contiguous()
    sub = torch.from_numpy(np.random.default_rng(7).permutation(ns_sv)[
        :2048]).to(dev)
    # torch.cdist is not called where its [M, T] matrix has 2^31 elements
    # or more: it refused 160,000 x 20,000 (invalid configuration).
    fits = lambda m, t: m * t < 2 ** 31
    q_seed = seed_lanes(sv_src[:, sub])
    nn_case("nn_argmin", *argmin, q_seed, cover, 20, 1,
            library=fits(q_seed.shape[0], cover.shape[0]))
    del q_seed
    q_rescore = seed_lanes(sv_src)
    nn_case("nn_min", *nmin, q_rescore, sv_pct, 5, 1,
            library=fits(q_rescore.shape[0], sv_pct.shape[0]))
    del q_rescore
    R_true = f32(np.stack([R for R, _ in serving["truth"]]))
    q_polish = torch.einsum("grc,gnc->gnr", R_true, sv_src).reshape(
        -1, 3).contiguous()
    nn_case("nn_argmin", *argmin, q_polish, sv_pct, 20, 2,
            library=fits(q_polish.shape[0], sv_pct.shape[0]))
    nn_case("nn_min", *nmin, sv_pct, cover, 50, 10)
    del q_polish
    nn_edges(torch, dev)

    def groups(g, src, spans_lo=0.03, spans_hi=0.25, deltas=None):
        """base [g, ns, 3] and (gam_ub, gam_lb) for g random rotation
        groups, the first half fixed-rotation (the ub pass)."""
        Rg = geo.quat_cube_to_matrix(f32(rng.uniform(-0.6, 0.6, size=(g, 3))))
        base = torch.einsum("grc,nc->gnr", Rg, src).contiguous()
        spans = f32(rng.uniform(spans_lo, spans_hi, size=(g,)))
        fix = torch.arange(g, device=dev) < g // 2
        gam_ub, gam_lb = bounds_ops.gamma_arrays(
            torch.linalg.vector_norm(src, dim=-1), spans, fix,
            point_deltas=deltas)
        return base, gam_ub.contiguous(), gam_lb.contiguous()

    def lanes_of(g, lanes):
        gids = torch.as_tensor(rng.integers(0, g, size=(lanes,)),
                               dtype=torch.int32, device=dev)
        t_l = f32(rng.uniform(-0.5, 0.5, size=(lanes, 3)))
        gam_t = geo.translation_uncertainty_radius(
            f32(rng.uniform(0.05, 0.5, size=(lanes,))))
        return gids, t_l, gam_t

    def bisect_flops(lanes, ns):
        # The trimmed kernel's 27 passes of compares over both term arrays
        # (26 bisection counts and the kept sums).
        return 2.0 * 27 * lanes * ns

    def lane_bytes(g, ns, lanes, n_buckets=None):
        # base, gam_ub, gam_lb, w; gids, t, gam_t; lb, ub; the proxies, or
        # the pruned kernels' bucket rows, boxes and source order.
        search = 3 * n_prox if n_buckets is None else (
            n_buckets * (3 * cuda_bounds.BUCKET + 6) + ns)
        return 4.0 * (g * ns * 5 + ns + lanes * 7 + search)

    proxy_backend = bounds_ops.ProxyBackend(coreset=proxy)
    buckets = proxy_backend.buckets
    n_buckets = buckets.boxes.shape[0]

    def pruned_case(name, shape, src, kernel, bare, plain, launch, terms,
                    n_pairs, nbytes, reps, plain_reps, extra_flops=0.0,
                    proxies=None):
        """A box-pruned kernel at a main-path shape.  kernel(w) is given the
        backend's buckets and the source's order, as GoICP gives them;
        bare(w) a bare proxies tensor and no order (buckets built per call);
        plain(w) its plain version; w [ns] point weights (None: the path's).
        lb / ub against the plain version; one-hot weights bit for bit
        against terms (the columns one-hot weights must give) at every
        source point through kernel, at `picks_of` through bare; the pairs evaluated and box tests
        (launch(counts), the kernel's counters), which set its bound
        (PAIR_FLOPS and BOX_FLOPS each, plus extra_flops, at the f32 peak,
        against the bytes), the full scan's bound beside it, and their issue
        ceiling; times: the kernel, the plain version, the buckets' and the
        order's builds, and bare."""
        ns = terms[0].shape[1]
        err = check_bounds(torch, name, kernel(None), plain(None))
        one_hot_terms(torch, name, kernel, terms, plain=plain)
        one_hot_terms(torch, f"{name} (bare proxies)", bare, terms,
                      picks_of(ns))
        pairs, tests = pair_counts(torch, launch)
        ms = cuda_ms(torch, lambda: kernel(None), reps)
        plain_ms = cuda_ms(torch, lambda: plain(None), plain_reps)
        case = report(name, shape, err, ms, plain_ms,
                      PAIR_FLOPS * pairs + BOX_FLOPS * tests + extra_flops,
                      nbytes)
        case["full_scan_bound_ms"] = bound(PAIR_FLOPS * n_pairs + extra_flops,
                                           nbytes)[0]
        px = prox if proxies is None else proxies
        bucket_ms = cuda_ms(torch, lambda: cuda_bounds.proxy_buckets(px),
                            reps)
        order_ms = cuda_ms(torch, lambda: cuda_bounds.source_order(src), reps)
        bare_ms = cuda_ms(torch, lambda: bare(None), reps)
        ceil_ms = (PAIR_INSTRS * pairs + BOX_INSTRS * tests) / INSTR_RATE * 1e3
        full_ms = PAIR_INSTRS * n_pairs / INSTR_RATE * 1e3
        say(f"kernel {name} [{shape}] pruning (kernel counters): {pairs} of "
            f"{n_pairs} pairs evaluated ({pairs / n_pairs!r}), {tests} box "
            f"tests; bound {case['bound_ms']!r} ms for these (full scan "
            f"{case['full_scan_bound_ms']!r} ms), issue ceiling {ceil_ms!r} "
            f"ms (full scan {full_ms!r} ms); buckets build {bucket_ms!r} ms, "
            f"source order build {order_ms!r} ms, wrapper given bare proxies "
            f"{bare_ms!r} ms; one-hot weights bit-equal at all {ns} points")
        return case

    # fused_bounds_lanes: G = 256 groups (ub + lb pass of 128 children),
    # L = 1024 lanes, 1,024 cluster reps, 1,024 proxies.
    g, lanes, reps_pts = 256, 1024, clusters.reps
    base, gam_ub, gam_lb = groups(g, reps_pts, deltas=clusters.deltas)
    gids, t_l, gam_t = lanes_of(g, lanes)
    w = clusters.weights.contiguous()
    ns = reps_pts.shape[0]
    slack32 = float(np.float32(slack))
    order1 = cuda_bounds.source_order(reps_pts)
    b1 = pruned_case(
        "fused_bounds_lanes", f"G{g} L{lanes} ns{ns} P{n_prox}", reps_pts,
        lambda wt: cuda_bounds.fused_bounds_lanes(
            base, gids, t_l, buckets, gam_ub, gam_t, slack,
            point_weights=w if wt is None else wt, gam_lb=gam_lb,
            point_order=order1),
        lambda wt: cuda_bounds.fused_bounds_lanes(
            base, gids, t_l, prox, gam_ub, gam_t, slack,
            point_weights=w if wt is None else wt, gam_lb=gam_lb),
        lambda wt: cuda_bounds.fused_bounds_lanes_plain(
            base, gids, t_l, prox, gam_ub, gam_lb, gam_t, slack32,
            w if wt is None else wt),
        lambda c: cuda_bounds._launch_lanes(
            base, gids, t_l, gam_ub, gam_lb, gam_t, w, slack32, buckets,
            order1, c),
        plain_terms(torch, base, gids, t_l, prox, gam_ub, gam_lb, gam_t,
                    slack32),
        lanes * ns * n_prox, lane_bytes(g, ns, lanes, n_buckets), 50, 5)

    # fused_bounds_lanes at a serving fallback's shape: 9a's first source
    # normalized as GoICP does, its 2,048 automatic clusters, and the
    # service's shared 1,024-point coreset of the centred target rescaled
    # to the pair (GoICP shared_proxy).
    scale_fb = 1.0 / torch.max(torch.abs(sv_src[0]))
    shared = coreset_ops.build(sv_pct, size=1024, seed=0)
    prox_fb = (shared.points * scale_fb).contiguous()
    slack_fb = float(np.float32(float(shared.eps * scale_fb)))
    cl_fb = coreset_ops.build_weighted(sv_src[0] * scale_fb, size=2048,
                                       seed=2)
    base_fb, gub_fb, glb_fb = groups(g, cl_fb.reps, deltas=cl_fb.deltas)
    gids_fb, t_fb, gt_fb = lanes_of(g, lanes)
    w_fb = cl_fb.weights.contiguous()
    ns_fb = cl_fb.reps.shape[0]
    buckets_fb = cuda_bounds.proxy_buckets(prox_fb)
    order_fb = cuda_bounds.source_order(cl_fb.reps)
    pruned_case(
        "fused_bounds_lanes",
        f"G{g} L{lanes} ns{ns_fb} P{prox_fb.shape[0]} (serving fallback)",
        cl_fb.reps,
        lambda wt: cuda_bounds.fused_bounds_lanes(
            base_fb, gids_fb, t_fb, buckets_fb, gub_fb, gt_fb, slack_fb,
            point_weights=w_fb if wt is None else wt, gam_lb=glb_fb,
            point_order=order_fb),
        lambda wt: cuda_bounds.fused_bounds_lanes(
            base_fb, gids_fb, t_fb, prox_fb, gub_fb, gt_fb, slack_fb,
            point_weights=w_fb if wt is None else wt, gam_lb=glb_fb),
        lambda wt: cuda_bounds.fused_bounds_lanes_plain(
            base_fb, gids_fb, t_fb, prox_fb, gub_fb, glb_fb, gt_fb, slack_fb,
            w_fb if wt is None else wt),
        lambda c: cuda_bounds._launch_lanes(
            base_fb, gids_fb, t_fb, gub_fb, glb_fb, gt_fb, w_fb, slack_fb,
            buckets_fb, order_fb, c),
        plain_terms(torch, base_fb, gids_fb, t_fb, prox_fb, gub_fb, glb_fb,
                    gt_fb, slack_fb),
        lanes * ns_fb * prox_fb.shape[0],
        lane_bytes(g, ns_fb, lanes, buckets_fb.boxes.shape[0]), 50, 5,
        proxies=prox_fb)
    del base_fb, gub_fb, glb_fb

    # fused_bounds_lanes_trimmed: the trimmed pooled lanes of the partial-
    # overlap pair, L = 1024 lanes over the full 10,000-point source,
    # n_drop = 3,000 (trim_fraction 0.3); and a few lanes of a 30,000-point
    # source, whose terms exceed shared memory (scratch path).  One-hot
    # weights run at n_drop 0, where the kernel's lb / ub are functions of
    # the one term (`trimmed_one_hot`); every other call at the path's
    # n_drop with unit weights.
    def trimmed_case(shape, src, base_, gids_, t_, gub_, glb_, gt_, n_drop_,
                     reps):
        ones_ = torch.ones(src.shape[0], dtype=torch.float32, device=dev)
        order_ = cuda_bounds.source_order(src)
        pick = lambda wt: (ones_, n_drop_) if wt is None else (wt, 0)
        lanes_ = gids_.shape[0]

        def kernel(wt, px=buckets, po=order_):
            w_, k_ = pick(wt)
            return cuda_bounds.fused_bounds_lanes_trimmed(
                base_, gids_, t_, px, gub_, gt_, slack, k_, point_weights=w_,
                gam_lb=glb_, point_order=po)

        def plain(wt):
            w_, k_ = pick(wt)
            return cuda_bounds.fused_bounds_lanes_trimmed_plain(
                base_, gids_, t_, prox, gub_, glb_, gt_, slack32, w_, k_)

        case = pruned_case(
            "fused_bounds_lanes_trimmed", shape, src, kernel,
            lambda wt: kernel(wt, prox, None), plain,
            lambda c: cuda_bounds._launch_lanes_trimmed(
                base_, gids_, t_, gub_, glb_, gt_, ones_, slack32, n_drop_,
                buckets, order_, c),
            trimmed_one_hot(torch, plain_terms(
                torch, base_, gids_, t_, prox, gub_, glb_, gt_, slack32)),
            lanes_ * src.shape[0] * n_prox,
            lane_bytes(base_.shape[0], src.shape[0], lanes_, n_buckets),
            reps, 1, bisect_flops(lanes_, src.shape[0]))
        return case, kernel

    ns5 = trim_src.shape[0]
    n_drop = int(round(0.3 * ns5))
    base5, gub5, glb5 = groups(g, trim_src)
    gids5, t5, gt5 = lanes_of(g, lanes)
    b5, trimmed5 = trimmed_case(
        f"G{g} L{lanes} ns{ns5} P{n_prox} n_drop{n_drop}", trim_src, base5,
        gids5, t5, gub5, glb5, gt5, n_drop, 10)
    trimmed = lambda: trimmed5(None)

    def unfused():
        """The unfused trimmed lane path: the nearest-proxy kernel on all
        L x ns queries, then the torch terms and bisection brackets."""
        lb_pt, ub_pt = bounds_ops.point_terms(
            proxy_backend, base5[gids5.long()] + t5[:, None, :],
            gub5[gids5.long()], glb5[gids5.long()], gt5)
        keep = ns5 - n_drop
        return (bounds_ops.reduce_point_terms(lb_pt, None, keep,
                                              drop_mode="over"),
                bounds_ops.reduce_point_terms(ub_pt, None, keep,
                                              drop_mode="under"))

    # The unfused path forms each trimmed bound as a lane total minus its
    # drop sum, so its rounding shows relative to the untrimmed total
    # (rtol 2e-4 of it).
    fused, plain_u = trimmed(), unfused()
    totals = cuda_bounds.fused_bounds_lanes(base5, gids5, t5, prox, gub5,
                                            gt5, slack, gam_lb=glb5)
    err_u = 0.0
    for k, p, tot in zip(fused, plain_u, totals):
        err = (k - p).abs()
        err_u = max(err_u, float(err.max()))
        if not bool(torch.all(err <= 2e-5 + 2e-4 * tot.abs())):
            raise AssertionError(f"unfused trimmed lanes: max abs err "
                                 f"{float(err.max())} beyond 2e-4 of the "
                                 f"lane totals")
    unfused_ms = cuda_ms(torch, unfused, 5)
    b5_again_ms = cuda_ms(torch, trimmed, 10)
    say(f"trimmed lanes, fused kernel vs unfused path (nn_min kernel + "
        f"torch bracket): fused {b5['ms']!r} / "
        f"{b5_again_ms!r} ms, unfused {unfused_ms!r} ms, max_abs_err "
        f"{err_u!r}")

    src30 = torch.cat([trim_src, trim_src * 0.97, trim_src * 1.03])
    base6, gub6, glb6 = groups(8, src30)
    gids6, t6, gt6 = lanes_of(8, 32)
    n_drop6 = int(round(0.3 * src30.shape[0]))
    trimmed_case(f"G8 L32 ns{src30.shape[0]} P{n_prox} n_drop{n_drop6} "
                 f"(terms in scratch)", src30, base6, gids6, t6, gub6, glb6,
                 gt6, n_drop6, 5)

    # fused_bounds: the grouped scheduler's grid, G = 256 groups x B = 32
    # translation nodes over the full 3,000-point source.
    n_trans, ns4 = 32, pcs.shape[0]
    base4, gub4, glb4 = groups(g, pcs)
    tc4 = f32(rng.uniform(-0.5, 0.5, size=(g, n_trans, 3)))
    gt4 = geo.translation_uncertainty_radius(
        f32(rng.uniform(0.05, 0.5, size=(g, n_trans))))
    ones4 = torch.ones(ns4, dtype=torch.float32, device=dev)
    order4 = cuda_bounds.source_order(pcs)
    gids4 = torch.arange(g, dtype=torch.int32, device=dev).repeat_interleave(
        n_trans)
    b4 = pruned_case(
        "fused_bounds", f"G{g} B{n_trans} ns{ns4} P{n_prox}", pcs,
        lambda wt: cuda_bounds.fused_bounds(
            base4, tc4, buckets, gub4, gt4, slack, point_weights=wt,
            gam_lb=glb4, point_order=order4),
        lambda wt: cuda_bounds.fused_bounds(
            base4, tc4, prox, gub4, gt4, slack, point_weights=wt,
            gam_lb=glb4),
        lambda wt: cuda_bounds.fused_bounds_plain(
            base4, tc4, prox, gub4, glb4, gt4, slack32,
            ones4 if wt is None else wt),
        lambda c: cuda_bounds._launch_grid(base4, tc4, gub4, glb4, gt4,
                                           ones4, slack32, buckets, order4, c),
        plain_terms(torch, base4, gids4, tc4.reshape(-1, 3), prox, gub4,
                    glb4, gt4.reshape(-1), slack32),
        g * n_trans * ns4 * n_prox,
        4.0 * (g * ns4 * 5 + ns4 + g * n_trans * 6
               + n_buckets * (3 * cuda_bounds.BUCKET + 6) + ns4), 10, 1)
    bounds_edges(torch, dev)

    bounds_src = "fgoicp_tpu_torch/csrc/"
    return [
        row("nn_argmin", "fgoicp_tpu_torch/csrc/nn.cu",
            "fgoicp_tpu/ops/pallas_nn.py:106", a1),
        row("nn_min", "fgoicp_tpu_torch/csrc/nn.cu",
            "fgoicp_tpu/ops/pallas_nn.py:152", m1),
        row("fused_bounds_lanes", bounds_src + "bounds_lanes.cu",
            "fgoicp_tpu/ops/pallas_bounds.py:311", b1),
        row("fused_bounds_lanes_trimmed", bounds_src + "bounds_lanes_trimmed.cu",
            "fgoicp_tpu/ops/pallas_bounds.py:227", b5),
        row("fused_bounds", bounds_src + "bounds_grid.cu",
            "fgoicp_tpu/ops/pallas_bounds.py:404", b4),
    ]


def compare_minplus(torch, norm, resolution=LUT_RESOLUTION):
    """Phase 2, `minplus_1d`: the kernel against its plain version, bit for
    bit, on seeded random lines (every third all BIG, as unseeded grid
    lines), constant, negative and few-valued lines, and on the three
    passes of the EDT of the smoke target's field at lut_resolution 0.002,
    whose inputs are the seeded grid and the permuted outputs of the passes
    before; kernel and plain times per full pass by CUDA events, beside the
    bound: an add and a min per (line, i, j) triple the kernel evaluated
    (its counter; it skips triples that cannot win) at the f32 peak,
    against one read and one write of the grid, with the bound of all
    L n^2 triples beside it.  No PyTorch call computes a min-plus product:
    library none.  Returns the JSON row."""
    from fgoicp_tpu_torch.ops import cuda_minplus
    from fgoicp_tpu_torch.ops import distance_field as df

    kernel, plain = cuda_minplus.minplus_1d, cuda_minplus.minplus_1d_plain
    dev = norm.pct.device

    def bit_equal(name, g):
        got, want = kernel(g, resolution), plain(g, resolution)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            n_bad = int((got != want).sum())
            raise AssertionError(
                f"{name}: {n_bad} values differ from the plain version, max "
                f"abs err {float((got - want).abs().max())!r}")

    rng = np.random.default_rng(13)
    for lines, n in ((1, 1), (7, 2047), (1000, 333)):
        g = rng.uniform(0.0, 4.0, size=(lines, n)).astype(np.float32)
        g[::3] = df.BIG
        bit_equal(f"minplus_1d [{lines}x{n}]", torch.from_numpy(g).to(dev))
    for kind, g in (
            ("constant", np.repeat(rng.uniform(0.0, 4.0, size=(1000, 1)),
                                   333, axis=1)),
            ("negative", rng.uniform(-4.0, 0.5, size=(1000, 333))),
            ("few-valued", rng.choice([0.0, 0.25, 1.0], size=(1000, 333)))):
        bit_equal(f"minplus_1d [1000x333] {kind}",
                  torch.from_numpy(g.astype(np.float32)).to(dev))
    say("kernel minplus_1d [1x1], [7x2047], [1000x333] (every third line "
        "BIG), [1000x333] constant, negative and few-valued lines: "
        "bit-equal to the plain version")

    dims = df.grid_dims(norm.target_bounds.cpu().numpy(), resolution)
    x, y, z = dims
    f = df._seed_grid(norm.pct, norm.target_bounds[:, 0].contiguous(),
                      torch.tensor(resolution, device=dev), dims)
    say(f"kernel minplus_1d: the smoke target's field at lut_resolution "
        f"{resolution}: dims {dims}, {x * y * z} cells")
    total = dict(ms=0.0, plain_ms=0.0, flops=0.0, full_flops=0.0,
                 nbytes=0.0)
    for axis, (lines, n), perm in (("z", (x * y, z), (x, y, z)),
                                   ("y", (z * x, y), (z, x, y)),
                                   ("x", (y * z, x), (y, z, x))):
        g = f.reshape(lines, n)
        bit_equal(f"minplus_1d pass {axis} [{lines}x{n}]", g)
        counts = torch.zeros(2, dtype=torch.int64, device=dev)
        cuda_minplus._launch(g, resolution, counts)
        triples, staged = (int(v) for v in counts.cpu())
        ms = cuda_ms(torch, lambda: kernel(g, resolution), 3)
        plain_ms = cuda_ms(torch, lambda: plain(g, resolution), 1)
        flops, nbytes = 2.0 * triples, 8.0 * lines * n
        full_flops = 2.0 * lines * n * n
        report("minplus_1d", f"pass {axis}, {lines}x{n}", 0.0, ms, plain_ms,
               flops, nbytes)
        # (warp, chunk) visits: every chunk of every tile of every warp.
        chunks = -(-lines // cuda_minplus.WARP_LINES) * -(
            -n // cuda_minplus.CHUNK) * -(-n // cuda_minplus.TILE_OUT)
        say(f"kernel minplus_1d pass {axis} pruning (kernel counters): "
            f"{triples} of {lines * n * n} triples evaluated "
            f"({triples / (lines * n * n)!r}), {staged} of {chunks} (warp, "
            f"chunk) visits staged; bound of all triples "
            f"{bound(full_flops, nbytes)[0]!r} ms, issue ceiling of the "
            f"evaluated triples {2.0 * triples / INSTR_RATE * 1e3!r} ms")
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("flops", flops),
                       ("full_flops", full_flops), ("nbytes", nbytes)):
            total[key] += v
        f = kernel(g, resolution).reshape(perm).permute(2, 0, 1).contiguous()
        del g
    del f
    case = report("minplus_1d", f"EDT of the {dims} field, 3 passes", 0.0,
                  total["ms"], total["plain_ms"], total["flops"],
                  total["nbytes"])
    case["full_scan_bound_ms"] = bound(total["full_flops"],
                                       total["nbytes"])[0]
    return row("minplus_1d", "fgoicp_tpu_torch/csrc/minplus.cu",
               "fgoicp_tpu/ops/pallas_minplus.py:75", case)


# The FPS kernel's work a (point, step): 3 sub, 3 mul, 2 add and the min,
# and about 17 issued instructions with the loads, the store and the
# compare (counted from csrc/fps.cu).  One block walks every step, on one
# SM: beside the card's bound a call prints that SM's issue time (an issue
# ceiling, from the kernel's own count), and the latency bound: k - 1 times
# the kernel's step at n = 1, which is a block barrier and two warp
# reductions with no point to update (FPS_FLOOR_K steps, CUDA events).
FPS_OPS, FPS_INSTRS = 9.0, 17.0
SM_INSTR_RATE = INSTR_RATE / 132
FPS_FLOOR_K = 4096
# (n, k) of the main paths' FPS calls: the bunny proxies (17,953 -> 1,024)
# and clusters (3,037 -> 1,024), a serving fallback's clusters (8,000 ->
# 2,048), the serving seeding coreset (6,000 -> 4,096) and the fallbacks'
# shared proxy (6,000 -> 1,024).
FPS_SHAPES = ((17953, 1024), (3037, 1024), (8000, 2048), (6000, 4096),
              (6000, 1024))
LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def compare_fps(torch):
    """Phase 2, `farthest_point_sample`: the kernel's indices against the
    plain loop's on the same CUDA tensors (equal) at FPS_SHAPES (points of
    a seeded surface cloud), kernel and plain ms a call by CUDA events, us a
    step, the layout, the card's bound and the latency bound (k - 1 steps
    at the measured step floor); one SM's issue time is printed only; then
    a warm GoICP construction of a bunny-size pair (17,953 / 3,037 points)
    timed by the host clock, and again under torch.profiler for its kernel
    launches and FPS launches.  Returns the JSON row."""
    from torch.profiler import ProfilerActivity, profile

    from fgoicp_tpu_torch import GoICP
    from fgoicp_tpu_torch.ops import cuda_fps

    kernel, plain = (cuda_fps.farthest_point_sample,
                     cuda_fps.farthest_point_sample_plain)
    dev = torch.device("cuda")
    cloud = surface_cloud(np.random.default_rng(1), 24000)
    one = torch.from_numpy(np.ascontiguousarray(cloud[:1])).to(dev)
    floor_us = 1e3 * cuda_ms(torch, lambda: kernel(one, FPS_FLOOR_K), 20) / (
        FPS_FLOOR_K - 1)
    say(f"kernel farthest_point_sample: step floor {floor_us!r} us (n = 1, "
        f"{FPS_FLOOR_K} steps: one block barrier and two warp reductions)")
    cases = []
    for n, k in FPS_SHAPES:
        p = torch.from_numpy(np.ascontiguousarray(cloud[:n])).to(dev)
        got, want = kernel(p, k), plain(p, k)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"farthest_point_sample [{n}->{k}]: {int((got != want).sum())}"
                f" indices differ from the plain loop's")
        ms = cuda_ms(torch, lambda: kernel(p, k), 20)
        plain_ms = cuda_ms(torch, lambda: plain(p, k), 1)
        case = report("farthest_point_sample", f"{n}->{k}", 0.0, ms,
                      plain_ms, FPS_OPS * n * (k - 1), 12.0 * n + 8.0 * k)
        case.update(layout=cuda_fps.plan_layout(n),
                    us_per_step=1e3 * ms / (k - 1), step_floor_us=floor_us,
                    latency_bound_ms=floor_us * (k - 1) / 1e3)
        sm_issue_ms = FPS_INSTRS * n * (k - 1) / SM_INSTR_RATE * 1e3
        say(f"kernel farthest_point_sample [{n}->{k}]: indices equal to the "
            f"plain loop's, layout {case['layout']}, {case['us_per_step']!r} "
            f"us a step, latency bound {case['latency_bound_ms']!r} ms, "
            f"one SM's issue ceiling {sm_issue_ms!r} ms")
        cases.append(case)

    pct_np, pcs_np = known_transform_pair(cloud, 17953, 3037)[:2]
    construct = lambda: GoICP(pct_np, pcs_np, mse_threshold=1e-3,
                              device=dev)
    construct()
    torch.cuda.synchronize()
    t_run = time.time()
    construct()
    torch.cuda.synchronize()
    wall_ms = (time.time() - t_run) * 1e3
    fps0 = kernel.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        construct()
        torch.cuda.synchronize()
    n_launch = sum(e.count for e in prof.key_averages()
                   if e.key in LAUNCH_KEYS)
    say(f"bunny-size GoICP construction (17953 / 3037, warm): "
        f"{wall_ms!r} ms, {n_launch} kernel launches, "
        f"{kernel.launches - fps0} of them FPS")
    return row("farthest_point_sample", "fgoicp_tpu_torch/csrc/fps.cu",
               "none (fgoicp_tpu/ops/coreset.py: a lax.fori_loop)",
               dict(cases=cases, construct_ms=wall_ms,
                    construct_launches=n_launch,
                    construct_fps_launches=kernel.launches - fps0))


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


def lut_phase(torch, dev, pair, counted, launches, reset, nn_shapes):
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
        reset()
        t_run = time.time()
        model = GoICP(pair[0], pair[1], lut_resolution=LUT_RESOLUTION,
                      mse_threshold=1e-3,
                      engine=EngineConfig(icp_multi_start=False, seed=0),
                      bound_backend="lut", device=dev)
        R, t = model.run()
        torch.cuda.synchronize()
        wall = time.time() - t_run
        launched = {fn.__name__: fn.launches for fn in counted}
        for key, n in launched.items():
            launches[key] += n
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
            f"{launched}, NN launches by shape {nn_shapes()}")
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
    pts = surface_cloud(rng, 18000)
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


def serving_phase(torch, dev, data, counted, launches, reset, nn_shapes,
                  smi_line):
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
            reset()
            t_run = time.time()
            if srv is None:
                srv = make()
                torch.cuda.synchronize()
                setup = time.time() - t_run
            before = dict(vars(srv.stats))
            results = srv.register(batch)
            torch.cuda.synchronize()
            wall = time.time() - t_run
            launched = {fn.__name__: fn.launches for fn in counted}
            for key, n in launched.items():
                launches[key] += n
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
                f"shape {nn_shapes()}")
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


def checkpoint_phase(torch, dev, pair, counted, launches, reset, ref_sse,
                     host_steps):
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

        reset()
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
        launched = {fn.__name__: fn.launches for fn in counted}
        for key, n in launched.items():
            launches[key] += n
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


def overflow_phase(torch, dev, pair, counted, launches, reset, ref_sse):
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

    reset()
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
    launched = {fn.__name__: fn.launches for fn in counted}
    for key, n in launched.items():
        launches[key] += n
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
    from fgoicp_tpu_torch.ops import cuda_bounds, cuda_nn
    from fgoicp_tpu_torch.parallel import (ChaosCommunicator, MultiHostGoICP,
                                           initialize)
    counted = (cuda_nn.nn_argmin, cuda_nn.nn_min,
               cuda_bounds.fused_bounds_lanes,
               cuda_bounds.fused_bounds_lanes_trimmed,
               cuda_bounds.fused_bounds)
    pair = known_transform_pair(
        surface_cloud(np.random.default_rng(0), 24000), 18000, 3000)
    dev = torch.device("cuda")
    comm = ChaosCommunicator(initialize(f"localhost:{port}", 2, rank),
                             delay_s=0.0)
    runs = []
    for _ in range(2):
        for fn in counted:
            fn.launches = 0
        seen = len(comm.digests)
        torch.cuda.synchronize()
        t_run, cpu = time.time(), time.process_time()
        model = MultiHostGoICP(pair[0], pair[1], comm, mse_threshold=1e-3,
                               engine=multihost_engine(**MULTIHOST_A),
                               device=dev)
        R, t = model.run()
        torch.cuda.synchronize()
        wall, cpu = time.time() - t_run, time.process_time() - cpu
        launched = {fn.__name__: fn.launches for fn in counted}
        runs.append(dict(rank_summary(model, R, t, wall, pair, cpu),
                         launched=launched,
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


def multihost_phase(torch, dev, pair, counted, launches, reset, many,
                    smi_line):
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
        reset()
        comms, hosts, wall, cpu = thread_hosts(
            torch, dev, pair, multihost_engine(**kw), streams)
        launched = {fn.__name__: fn.launches for fn in counted}
        for key, k in launched.items():
            launches[key] += k
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
        for key, k in launched.items():
            launches[key] += k
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


# Kernels 1-4 and 6, whose launches on one rank's shards phases 12 and 13
# hold against their plain versions (kernel 5 runs only on cubes-only
# meshes and neither phase runs it; kernel 6 only for a LUT engine, 13c).
SHARD_KERNELS = ("nn_argmin", "nn_min", "fused_bounds_lanes", "fused_bounds",
                 "minplus_1d")
# Phase 15 holds every kernel its tools launch, the trimmed lanes too.
TOOL_KERNELS = SHARD_KERNELS + ("fused_bounds_lanes_trimmed",)
# The most distinct launch shapes a run keeps per kernel (the first seen).
SHARD_SHAPES = 12


def _shape_key(a):
    """What makes a kernel argument's launch shape: a tensor's shape and
    dtype, a bucket set's proxy count, an int's value (n_drop)."""
    if hasattr(a, "shape"):
        return tuple(a.shape), str(a.dtype)
    if hasattr(a, "points"):
        return "buckets", tuple(a.points.shape)
    return a if isinstance(a, (int, type(None))) else type(a).__name__


class ShardLaunches:
    """While on (`with`), the wrappers of `kernels` keep a copy of the
    arguments of their first launch at every distinct shape, as the path
    gives them; `check` then holds each against its plain version on the
    card.  The wrappers are swapped for forwarding objects, so the ops and
    the wrappers' own `.launches` counting see the same functions.  With
    plain_reps 0 the plain version runs once, its time that call's."""

    def __init__(self, torch, kernels=SHARD_KERNELS, plain_reps=2):
        from fgoicp_tpu_torch.ops import cuda_bounds, cuda_minplus, cuda_nn
        self.torch = torch
        self.plain_reps = plain_reps
        self.mods = {name: cuda_nn if name.startswith("nn_") else
                     cuda_minplus if name == "minplus_1d" else cuda_bounds
                     for name in kernels}
        self.calls = {}   # (label, name, shapes) -> (fn, args, kwargs)
        self.shapes = {}  # (label, name) -> distinct launch shapes seen
        self.label = None

    def record(self, label):
        self.label = label
        return self

    def __enter__(self):
        outer = self

        class Forward:
            def __init__(self, fn):
                object.__setattr__(self, "fn", fn)

            def __call__(self, *args, **kw):
                key = (outer.label, self.fn.__name__,
                       tuple(_shape_key(a) for a in args),
                       tuple(sorted((k, _shape_key(v))
                                    for k, v in kw.items())))
                seen = outer.shapes.setdefault(key[:2], set())
                seen.add(key[2:])
                if key not in outer.calls and len(seen) <= SHARD_SHAPES:
                    keep = lambda a: a.clone() if hasattr(a, "clone") else a
                    outer.calls[key] = (self.fn, [keep(a) for a in args],
                                        {k: keep(v) for k, v in kw.items()})
                return self.fn(*args, **kw)

            def __getattr__(self, name):
                return getattr(object.__getattribute__(self, "fn"), name)

            def __setattr__(self, name, value):
                setattr(object.__getattribute__(self, "fn"), name, value)

        for name, mod in self.mods.items():
            setattr(mod, name, Forward(getattr(mod, name)))
        return self

    def __exit__(self, *exc):
        for name, mod in self.mods.items():
            setattr(mod, name, getattr(mod, name).fn)

    def _plain(self, fn, args, kw):
        """(plain version's call, shape text, flops, bytes, counted launch
        or None, flops besides the search) of a launch.  For the pruned
        kernels the counted launch runs the kernel with its counters
        (`pair_counts`); flops are then the full scan's, every (lane,
        point, proxy) pair or (line, i, j) triple, plus the trimmed
        kernel's bisection (27 compare passes over both term arrays)."""
        import inspect
        torch = self.torch
        from fgoicp_tpu_torch.ops import cuda_bounds, cuda_minplus, cuda_nn
        a = inspect.signature(fn).bind(*args, **kw)
        a.apply_defaults()
        a = a.arguments
        name = fn.__name__
        if name in ("nn_argmin", "nn_min"):
            q, p = a["queries"], a["points"]
            m, t = q.shape[0], p.shape[0]
            plain = getattr(cuda_nn, name + "_plain")
            return (lambda: plain(q, p), f"{m}x{t}", 8.0 * m * t,
                    12.0 * (m + t) + 4 * m * (2 if name == "nn_argmin"
                                              else 1), None, 0.0)
        if name == "minplus_1d":
            g, res = a["g"], a["res"]
            lines, n = g.shape
            return (lambda: cuda_minplus.minplus_1d_plain(g, res),
                    f"{lines}x{n}", 2.0 * lines * n * n, 8.0 * lines * n,
                    lambda c: cuda_minplus._launch(g, res, c), 0.0)
        base = a["base"]
        ns = base.shape[1]
        proxies, buckets = cuda_bounds._search_args(
            name, a["proxies"], a["point_order"], ns)
        if buckets is None:
            buckets = cuda_bounds.proxy_buckets(proxies)
        slack = float(np.float32(float(a["slack"])))
        gam_lb = a["gam_ub"] if a["gam_lb"] is None else a["gam_lb"]
        w = (torch.ones(ns, dtype=torch.float32, device=base.device)
             if a["point_weights"] is None else a["point_weights"])
        n_prox = proxies.shape[0]
        order = a["point_order"]
        extra = 0.0
        if name == "fused_bounds_lanes_trimmed":
            lanes, n_drop = a["gids"].shape[0], a["n_drop"]
            plain = lambda: cuda_bounds.fused_bounds_lanes_trimmed_plain(
                base, a["gids"], a["t_lanes"], proxies, a["gam_ub"], gam_lb,
                a["gam_t_lanes"], slack, w, n_drop)
            counted = lambda c: cuda_bounds._launch_lanes_trimmed(
                base, a["gids"], a["t_lanes"], a["gam_ub"], gam_lb,
                a["gam_t_lanes"], w, slack, n_drop, buckets, order, c)
            shape = (f"G{base.shape[0]} L{lanes} ns{ns} P{n_prox} "
                     f"n_drop{n_drop}")
            extra = 2.0 * 27 * lanes * ns
        elif name == "fused_bounds":
            tc = a["t_centers"]
            lanes = tc.shape[0] * tc.shape[1]
            plain = lambda: cuda_bounds.fused_bounds_plain(
                base, tc, proxies, a["gam_ub"], gam_lb, a["gam_t"], slack, w)
            counted = lambda c: cuda_bounds._launch_grid(
                base, tc, a["gam_ub"], gam_lb, a["gam_t"], w, slack,
                buckets, order, c)
            shape = f"G{base.shape[0]} B{tc.shape[1]} ns{ns} P{n_prox}"
        else:
            lanes = a["gids"].shape[0]
            plain = lambda: cuda_bounds.fused_bounds_lanes_plain(
                base, a["gids"], a["t_lanes"], proxies, a["gam_ub"], gam_lb,
                a["gam_t_lanes"], slack, w)
            counted = lambda c: cuda_bounds._launch_lanes(
                base, a["gids"], a["t_lanes"], a["gam_ub"], gam_lb,
                a["gam_t_lanes"], w, slack, buckets, order, c)
            shape = f"G{base.shape[0]} L{lanes} ns{ns} P{n_prox}"
        return (plain, shape, PAIR_FLOPS * lanes * ns * n_prox + extra,
                4.0 * (base.numel() + 2 * base.shape[0] * ns + ns
                       + 3 * n_prox + 5 * lanes + 2 * lanes), counted, extra)

    def check(self):
        """Every recorded launch against its plain version (NN and
        minplus_1d bit for bit; bounds rtol 2e-4 / atol 2e-5 and lb <= ub),
        each timed on the card; returns one dict per launch shape, with the
        number of distinct shapes its run launched the kernel at (`of`).
        For the pruned kernels `bound_ms` is the bound of the work the
        kernel's counters report (8 flops a pair and 17 a box test, 2 a
        min-plus triple), `full_scan_bound_ms` the full scan's."""
        import inspect
        torch = self.torch
        out = []
        for (label, name, _, _), (fn, args, kw) in self.calls.items():
            plain, shape, flops, nbytes, counted, extra = self._plain(
                fn, args, kw)
            kernel = lambda: fn(*args, **kw)
            if self.plain_reps:
                want = plain()
                plain_ms = cuda_ms(torch, plain, self.plain_reps)
            else:
                want, plain_ms = timed_once(torch, plain)
            if name in ("nn_argmin", "nn_min"):
                err = nn_equal(torch, f"{label} {name} [{shape}]", kernel(),
                               want)
            elif name == "minplus_1d":
                got = kernel()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"{label} minplus_1d [{shape}]: "
                        f"{int((got != want).sum())} values differ from the "
                        f"plain version")
                err = 0.0
            else:
                err = check_bounds(torch, f"{label} {name} [{shape}]",
                                   kernel(), want)
            full_bound_ms, bound_by = bound(flops, nbytes)
            work = None
            if counted is not None:
                work = pair_counts(torch, counted)
                done = (2.0 * work[0] if name == "minplus_1d" else
                        PAIR_FLOPS * work[0] + BOX_FLOPS * work[1] + extra)
                bound_ms, bound_by = bound(done, nbytes)
            else:
                bound_ms = full_bound_ms
            # The library yardstick of phase 2 (torch.cdist, then the
            # min), where its [M, T] matrix has fewer than 2^31 elements.
            library_ms = None
            if name in ("nn_argmin", "nn_min"):
                bound_args = inspect.signature(fn).bind(*args, **kw)
                q, p = (bound_args.arguments[k] for k in ("queries",
                                                          "points"))
                reduce = (lambda d: torch.min(d, dim=1)) \
                    if name == "nn_argmin" \
                    else (lambda d: torch.amin(d, dim=1))
                try:
                    if q.shape[0] * p.shape[0] >= 2 ** 31:
                        raise RuntimeError("2^31 elements or more")
                    library_ms = cuda_ms(torch, lambda: reduce(torch.cdist(
                        q, p, compute_mode="donot_use_mm_for_euclid_dist")),
                        1)
                except RuntimeError as exc:
                    say(f"{label} {name} [{shape}]: library refused ({exc})")
            out.append(dict(label=label, name=name, shape=shape,
                            library_ms=library_ms,
                            of=len(self.shapes[(label, name)]),
                            max_abs_err=err, ms=cuda_ms(torch, kernel, 10),
                            plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            full_scan_bound_ms=full_bound_ms, work=work))
        self.calls.clear()
        self.shapes.clear()
        return out


def mesh_worker(label, nc, np_, rank, port, out_path) -> int:
    """Phase 12's worker (`chip_smoke.py --mesh-worker LABEL NC NP RANK PORT
    OUT`): one rank of an nc x np_ mesh on this card, joined by the user
    entry points themselves (register(Config) with engine.mesh_cubes /
    mesh_points, or make_mesh for serving) over env://, as torchrun starts
    ranks.  Runs the sub-phase cold, then warm, in this process and writes
    its summaries to OUT.  Rank 0 keeps its cold runs' kernel launches
    (`ShardLaunches`) and, once the mesh is down, holds each launch shape
    against the kernel's plain version."""
    import contextlib
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
    from fgoicp_tpu_torch.ops import cuda_bounds, cuda_nn
    counted = (cuda_nn.nn_argmin, cuda_nn.nn_min,
               cuda_bounds.fused_bounds_lanes,
               cuda_bounds.fused_bounds_lanes_trimmed,
               cuda_bounds.fused_bounds)
    shard_launches = ShardLaunches(torch) if rank == 0 else None

    def recording(run, name):
        """Rank 0's cold runs keep their launches' arguments."""
        if shard_launches is None or run != "cold":
            return contextlib.nullcontext()
        return shard_launches.record(f"{label} {name}")

    def drive(name, kind, truth, **engine):
        """register() cold, then warm: [(model, summary)] of both runs."""
        cfg = Config.from_toml(str(WORK / f"{name}.toml"))
        for key, value in dict(engine, icp_multi_start=False,
                               mesh_cubes=nc, mesh_points=np_).items():
            setattr(cfg.engine, key, value)
        pct, pcs = load_cloud(cfg.io.target), load_cloud(cfg.io.source)
        out = []
        for run in ("cold", "warm"):
            for fn in counted:
                fn.launches = 0
            torch.cuda.synchronize()
            t_run = time.time()
            with recording(run, kind):
                model, R, t = register(cfg, pct, pcs, device="cuda")
            torch.cuda.synchronize()
            wall = time.time() - t_run
            launched = {fn.__name__: fn.launches for fn in counted}
            out.append((model, mesh_run_summary(
                f"{label} {kind} {run}", kind, model, R, t, wall, truth,
                launched)))
        return out

    pair = known_transform_pair(
        surface_cloud(np.random.default_rng(0), 24000), 18000, 3000)
    runs = []
    if label == "12d":
        import hashlib
        from fgoicp_tpu_torch.models.serving import RegistrationService
        from fgoicp_tpu_torch.parallel import make_mesh
        data = serving_data()
        mesh = make_mesh(nc, np_, device="cuda")
        srv = RegistrationService(data["pct"], mse_threshold=1e-3,
                                  mesh=mesh, device="cuda")
        for run in ("cold", "warm"):
            for fn in counted:
                fn.launches = 0
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
                launched={fn.__name__: fn.launches for fn in counted},
                digest=hashlib.sha256(b"".join(a.tobytes() for a in arrays))
                .hexdigest()))
    elif label == "12b":
        runs += [summary for _, summary in drive("smoke", "smoke", pair)]
        runs += [summary for _, summary in drive(
            "smoke", "grouped", pair, frontier_mode="grouped")]
        runs += [summary for _, summary in drive(
            "trimmed", "trimmed", partial_overlap_pair())]
    else:
        runs += [summary for _, summary in drive(
            "smoke", "device" if label == "12c" else "smoke", pair,
            **(dict(outer_mode="device") if label == "12c" else {}))]
    torch.distributed.destroy_process_group()
    if shard_launches is not None:
        runs[0]["shard_kernels"] = shard_launches.check()
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


def shard_work(k):
    """A pruned kernel's work from its counters, beside the full scan's."""
    if k.get("work") is None:
        return ""
    what = ("(line, i, j) triples evaluated, (warp, chunk) pairs staged"
            if k["name"] == "minplus_1d" else
            "(point, proxy) pairs evaluated, (point, box) tests")
    return (f"; counters: {what} {k['work']}; bound of that work "
            f"{k['bound_ms']!r} ms, of the full scan "
            f"{k['full_scan_bound_ms']!r} ms")


def mesh_phase(torch, launches, refs, refs_wall, served, serving,
               smi_line):
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
    at which its cold runs launched kernels 1-4 against the plain versions;
    each of the four must have been held at some shape."""
    import types
    need = {"smoke": ("nn_argmin", "fused_bounds_lanes"),
            "grouped": ("nn_argmin", "fused_bounds"),
            "trimmed": ("nn_argmin", "nn_min"),
            "device": ("nn_argmin", "nn_min", "fused_bounds_lanes"),
            "serving": ("nn_argmin", "nn_min")}
    held = {name: 0 for name in SHARD_KERNELS if name != "minplus_1d"}
    for label, nc, np_ in MESH_PHASES:
        by_rank, wall = mesh_processes(label, nc, np_)
        for k in by_rank[0][0].get("shard_kernels", []):
            held[k["name"]] += 1
            say(f"{k['label']} rank 0 shard launch {k['name']} "
                f"[{k['shape']}] (of {k['of']} shapes) ({smi_line}): "
                f"max_abs_err "
                f"{k['max_abs_err']!r} against its plain version, kernel "
                f"{k['ms']!r} ms, plain {k['plain_ms']!r} ms, bound "
                f"{k['bound_ms']!r} ms ({k['bound_by']}), library "
                f"{k['library_ms']!r} ms{shard_work(k)}")
        say(f"{label} ({smi_line}): {nc} x {np_} mesh, {nc * np_} gloo "
            f"processes on one card, wall {wall!r} s from start to exit")
        for i in range(len(by_rank[0])):
            ranks = [runs[i] for runs in by_rank]
            name, kind = ranks[0]["label"], ranks[0]["kind"]
            launched = {k: sum(h["launched"][k] for h in ranks)
                        for k in ranks[0]["launched"]}
            for key, k in launched.items():
                launches[key] += k
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
    missing = [name for name, n in held.items() if not n]
    if missing:
        raise AssertionError(f"phase 12: kernels {missing} never held "
                             f"against their plain versions at a shard "
                             f"shape")
    say(f"phase 12 ({smi_line}): launch shapes held against the plain "
        f"versions on rank 0 of each sub-phase: {held}")


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
    and state digest to OUT.  Rank 0 keeps its cold run's launches
    (`ShardLaunches`) and holds each shape against its plain version once
    the world is down."""
    import contextlib
    import torch
    if not torch.cuda.is_available():
        print("host-mesh worker: no CUDA device", file=sys.stderr)
        return 1
    import torch.distributed
    from fgoicp_tpu_torch.ops import cuda_bounds, cuda_minplus, cuda_nn
    from fgoicp_tpu_torch.parallel import ChaosCommunicator, initialize
    from fgoicp_tpu_torch.parallel.distributed import (MultiHostGoICP,
                                                       make_host_mesh)
    (kw, extra), = [(k, e) for lab, _, _, k, e in HOST_MESH_PHASES
                    if lab == label]
    counted = (cuda_nn.nn_argmin, cuda_nn.nn_min,
               cuda_bounds.fused_bounds_lanes,
               cuda_bounds.fused_bounds_lanes_trimmed,
               cuda_bounds.fused_bounds, cuda_minplus.minplus_1d)
    pair = known_transform_pair(
        surface_cloud(np.random.default_rng(0), 24000), 18000, 3000)
    initialize(f"localhost:{port}", HOST_MESH_HOSTS * nc * np_, rank,
               timeout=HOSTS_JOIN_S)
    inner, mesh = make_host_mesh(HOST_MESH_HOSTS, nc, np_, device="cuda",
                                 timeout=HOSTS_JOIN_S)
    comm = ChaosCommunicator(inner, delay_s=0.0)
    shard_launches = ShardLaunches(torch) if rank == 0 else None
    kind = "lut" if extra else kw["outer_mode"]
    runs = []
    for run in ("cold", "warm"):
        for fn in counted:
            fn.launches = 0
        mesh.reset_counters()
        seen = len(comm.digests)
        recording = (shard_launches.record(f"{label} {kind}")
                     if shard_launches is not None and run == "cold"
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
            launched={fn.__name__: fn.launches for fn in counted},
            digests=[d.hex() for d in comm.digests[seen:]],
            mesh=mesh.counters(), state=state_digest(model, R, t)))
    torch.distributed.destroy_process_group()
    if shard_launches is not None:
        runs[0]["shard_kernels"] = shard_launches.check()
    pathlib.Path(out_path).write_text(json.dumps(runs))
    return 0


def hostmesh_phase(launches, many, smi_line):
    """Phase 13: hosts on meshes, HOST_MESH_HOSTS hosts of nc x np_ gloo
    processes on this card, each sub-phase cold then warm.  Gate on every
    rank: the certificate and check_result's pose gate on the certified
    pose's basin, best_sse within sse_threshold of phase 11's single host
    (`many` by outer mode); every rank's gather digests equal (the host
    groups of all mesh positions agree), a host's mesh ranks with equal
    state digests, donated == stolen counted at each host's mesh position
    0, the path's kernels launched (13c: minplus_1d three times a rank and
    no proxy lane kernel).  Rank 0's cold-run launch shapes are held against
    the plain versions; minplus_1d must be held in 13c."""
    import types
    held = {}
    for label, nc, np_, kw, extra in HOST_MESH_PHASES:
        by_rank, wall = mesh_processes(label, nc, np_, hosts=HOST_MESH_HOSTS)
        for k in by_rank[0][0].get("shard_kernels", []):
            held[k["name"]] = held.get(k["name"], 0) + 1
            say(f"{k['label']} rank 0 shard launch {k['name']} "
                f"[{k['shape']}] (of {k['of']} shapes) ({smi_line}): "
                f"max_abs_err {k['max_abs_err']!r} against its plain "
                f"version, kernel {k['ms']!r} ms, plain {k['plain_ms']!r} "
                f"ms, bound {k['bound_ms']!r} ms ({k['bound_by']}), library "
                f"{k['library_ms']!r} ms{shard_work(k)}")
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
            for key, k in launched.items():
                launches[key] += k
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
    if not held.get("minplus_1d") or not held.get("fused_bounds_lanes") \
            or not held.get("nn_argmin"):
        raise AssertionError(f"phase 13: kernels held at shard shapes "
                             f"{held}; minplus_1d, fused_bounds_lanes and "
                             f"nn_argmin must each be held")
    say(f"phase 13 ({smi_line}): launch shapes held against the plain "
        f"versions on rank 0 of each sub-phase: {held}")


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


def kernel_check_phase(smi_line):
    """Phase 14c: `python -m fgoicp_tpu_torch.scripts.kernel_check --grid
    reduced`, whose JSON must read ok true; each row printed."""
    out = WORK / "kernel_check_reduced.json"
    proc = subprocess.run(
        [sys.executable, "-m", "fgoicp_tpu_torch.scripts.kernel_check",
         "--grid", "reduced", "--out", str(out)], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"kernel_check exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    res = json.loads(out.read_text())
    for r in res["rows"]:
        say(f"kernel_check {r['kernel']} [{r['shape']}] ({smi_line}): "
            f"{'OK' if r['ok'] else 'MISMATCH'}, max_abs_err "
            f"{r['max_abs_err']!r}, kernel {r.get('ms')!r} ms"
            + (f", pairs / box tests {r['pairs_boxes']} of "
               f"{r['full_pairs']} pairs" if r.get("pairs_boxes") else ""))
    if not res["ok"]:
        raise AssertionError("kernel_check: a row did not pass")
    say(f"kernel_check --grid reduced ({smi_line}): ok, {len(res['rows'])} "
        f"rows in {res['seconds']!r} s")


def tools_phase(torch, counted, launches, reset, trimmed_nodes, smi_line):
    """Phase 15: the experiment tools of fgoicp_tpu_torch/scripts, called as
    functions at their defaults, each with every launch counter set to 0
    just before it and read just after, and every launch shape it gives the
    kernels held against the plain versions afterwards (`ShardLaunches`,
    the plain version once a shape: NN and minplus_1d bit for bit, bounds
    at phase 2's rtol 2e-4 / atol 2e-5), with its time, bound and library
    time.  Gates: 15a step_decomp's pieces sum to no more than a step; 15b
    micro_step's bare kernel to no more than a pooled step; 15c
    mxu_experiment launches nn_min (its norm-expansion errors are printed,
    not gated); 15d minplus_experiment's f64 gate, its kernel bit-equal to
    the plain version at [262,144 x 1,024] and the two EDT fields equal;
    15e hard_pairs --pair synth in host and device outer mode: certified,
    the seeding's gap open, rotation_children > 0 and more translation
    nodes than phase 5's trimmed search-only (`trimmed_nodes`), and the
    certified pose in the known pose's basin (R < 5e-3, t < 5e-3 x span
    after one converged trimmed ICP); 15f serving_experiment ragged and
    fallback: every pair certified, and the fallback mode takes a fallback
    that launches fused_bounds_lanes_trimmed."""
    from fgoicp_tpu_torch.scripts import (
        hard_pairs, micro_step, minplus_experiment, mxu_experiment,
        serving_experiment, step_decomp)
    rec = ShardLaunches(torch, TOOL_KERNELS, plain_reps=0)

    def tool(label, call, need):
        reset()
        t_run = time.time()
        with rec.record(label):
            out = call()
        torch.cuda.synchronize()
        wall = time.time() - t_run
        launched = {fn.__name__: fn.launches for fn in counted}
        for key, n in launched.items():
            launches[key] += n
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
    held = {}
    for k in rec.check():
        held[k["name"]] = held.get(k["name"], 0) + 1
        say(f"{k['label']} launch {k['name']} [{k['shape']}] (of {k['of']} "
            f"shapes) ({smi_line}): max_abs_err {k['max_abs_err']!r} "
            f"against its plain version, kernel {k['ms']!r} ms, plain "
            f"{k['plain_ms']!r} ms, bound {k['bound_ms']!r} ms "
            f"({k['bound_by']}), library {k['library_ms']!r} ms"
            f"{shard_work(k)}")
    missing = [k for k in TOOL_KERNELS if k != "fused_bounds" and
               not held.get(k)]
    if missing:
        raise AssertionError(f"phase 15: kernels {missing} held at no "
                             f"shape")
    say(f"phase 15 ({smi_line}): launch shapes held against the plain "
        f"versions: {held}")


ICP_ITERATIONS = 20


def device_us(torch, call, kernels, reps=20):
    """Mean device microseconds a launch of each named kernel over `reps`
    warm calls of call(), from torch.profiler's device events (a kernel
    shorter than its wrapper's host time reads as the host's time by CUDA
    events around calls queued back to back)."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    out = {}
    for name in kernels:
        events = [e for e in prof.key_averages() if name in e.key
                  and str(getattr(e, "device_type", "")).endswith("CUDA")]
        n = sum(e.count for e in events)
        out[name] = (sum(e.self_device_time_total for e in events) / n
                     if n else None)
    return out


def compare_icp(torch):
    """Phase 2, the ICP iteration's kernels at kernel_check.ICP_SHAPES (a
    seeded surface cloud, starts up to 0.5 rad from the identity, the
    callers' convergence thresholds): kernel_check.compare_icp_steps, every
    output of icp_align and icp_commit against their plain versions from
    the same state at every iteration until the lanes stop, the guard
    firing; each kernel's and plain version's ms a call by CUDA events
    (icp_commit with threshold -1, so no lane finishes while it is timed),
    the host clock's ms an iteration (align, NN, commit, the read of
    `running`) over ICP_ITERATIONS iterations, kernels against plain
    versions, and each kernel's device time a launch (`device_us`).
    Returns the JSON rows of both kernels."""
    from fgoicp_tpu_torch.ops import cuda_icp
    from fgoicp_tpu_torch.scripts import kernel_check as kc

    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    cloud = surface_cloud(rng, 24000)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    align_cases, commit_cases = [], []
    for g, ns, nt, thr in kc.ICP_SHAPES:
        pct = T(cloud[rng.choice(len(cloud), nt, replace=False)])
        src = T(cloud[rng.choice(len(cloud), ns, replace=False)])
        R0 = T(np.stack([turn(rng, 0.5 * i / g) for i in range(g)]))
        t0 = T(rng.uniform(-0.05, 0.05, size=(g, 3)).astype(np.float32))
        shape = f"{g}x{ns} on {nt}"
        out = kc.compare_icp_steps(pct, src, R0, t0, thr)
        if not out["ok"]:
            raise AssertionError(
                f"icp kernels [{shape}, threshold {thr}] against the plain "
                f"step: {out} (limits: R / t / last_R / last_t / points "
                f"{kc.ICP_ATOL}, SSE rtol {kc.ICP_SSE_RTOL}, done within "
                f"{kc.ICP_GUARD_BAND} of the threshold, guard fired)")

        def align(fn, s):
            return lambda: fn(pct, s["idx"], None, s["done"], s["cur"],
                              s["R"], s["t"], s["last_R"], s["last_t"],
                              s["running"])

        def commit(fn, s):
            return lambda: fn(s["d2"], None, -1.0, s["done"], s["sse"],
                              s["last_sse"], s["running"])

        s = kc.icp_state(pct, src, R0, t0)
        a_ms = cuda_ms(torch, align(cuda_icp.icp_align, s), 20)
        a_plain = cuda_ms(torch, align(cuda_icp.icp_align_plain, s), 3)
        c_ms = cuda_ms(torch, commit(cuda_icp.icp_commit, s), 20)
        c_plain = cuda_ms(torch, commit(cuda_icp.icp_commit_plain, s), 3)

        def iteration_ms(kernels):
            s = kc.icp_state(pct, src, R0, t0)
            torch.cuda.synchronize()
            t_run = time.perf_counter()
            for _ in range(ICP_ITERATIONS):
                kc.icp_step(s, pct, -1.0, kernels=kernels)
                int(s["running"].cpu()[0])
            return (time.perf_counter() - t_run) * 1e3 / ICP_ITERATIONS

        dev_us = device_us(torch, lambda: (align(cuda_icp.icp_align, s)(),
                                           commit(cuda_icp.icp_commit, s)()),
                           ("align_kernel", "commit_kernel"))
        it_k, it_p = iteration_ms(True), iteration_ms(False)
        (a_flops, a_bytes), (c_flops, c_bytes) = cuda_icp.traffic(g, ns)
        case = report("icp_align", shape, max(out["pose_err"],
                                               out["last_err"]),
                      a_ms, a_plain, a_flops, a_bytes)
        case.update(threads=cuda_icp.block_threads(ns), iteration_ms=it_k,
                    plain_iteration_ms=it_p, steps=out["steps"],
                    guard_fired=out["guard_fired"],
                    device_us=dev_us["align_kernel"])
        align_cases.append(case)
        case = report("icp_commit", shape, out["sse_rel_err"], c_ms, c_plain,
                      c_flops, c_bytes)
        case.update(device_us=dev_us["commit_kernel"])
        commit_cases.append(case)
        say(f"icp iteration [{shape}]: {out['steps']} steps against the "
            f"plain step, {out['guard_fired']} lanes stopped by the guard, "
            f"R / t / points within {max(out['pose_err'], out['last_err'])!r},"
            f" SSE within rtol {out['sse_rel_err']!r}; {it_k!r} ms on the "
            f"kernels, {it_p!r} ms on the plain versions (host clock, align "
            f"+ NN + commit + one read, {ICP_ITERATIONS} iterations); device "
            f"time a launch (profiler): icp_align {dev_us['align_kernel']!r}"
            f" us, icp_commit {dev_us['commit_kernel']!r} us")
    return [row("icp_align", "fgoicp_tpu_torch/csrc/icp_step.cu",
                "none (fgoicp_tpu/models/icp.py: XLA ops)",
                dict(cases=align_cases)),
            row("icp_commit", "fgoicp_tpu_torch/csrc/icp_step.cu",
                "none (fgoicp_tpu/models/icp.py: XLA ops)",
                dict(cases=commit_cases))]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA GPU", file=sys.stderr)
        return 1

    from fgoicp_tpu_torch import register
    from fgoicp_tpu_torch.kernels import build
    from fgoicp_tpu_torch.ops import cuda_bounds, cuda_fps, cuda_icp
    from fgoicp_tpu_torch.ops import cuda_minplus, cuda_nn
    from fgoicp_tpu_torch.ops import geometry as geo
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

    # The smoke pair: seed-0 Lissajous cloud of 24,000 points cut into an
    # 18,000-point target and a 3,000-point source moved by a known pose;
    # and the trimmed phase's partial-overlap pair.
    cloud = surface_cloud(np.random.default_rng(0), 24000)
    pair = known_transform_pair(cloud, 18000, 3000)
    trim_pair = partial_overlap_pair()
    dev = torch.device("cuda")
    WORK.mkdir(parents=True, exist_ok=True)
    cfg, pct_in, pcs_in = write_config(
        "smoke", pair[0], pair[1], "mse_threshold = 1e-3")
    tcfg, tpct_in, tpcs_in = write_config(
        "trimmed", trim_pair[0], trim_pair[1],
        "mse_threshold = 1e-3\ntrim = true\ntrim_fraction = 0.3")

    # Phase 2: kernels against their plain versions, in the normalized frame.
    norm = geo.Normalization(torch.from_numpy(pair[0]).to(dev),
                             torch.from_numpy(pair[1]).to(dev))
    trim_norm = geo.Normalization(torch.from_numpy(trim_pair[0]).to(dev),
                                  torch.from_numpy(trim_pair[1]).to(dev))
    serving = serving_data()
    kernels = compare_kernels(torch, norm.pct.contiguous(),
                              norm.pcs.contiguous(),
                              trim_norm.pct.contiguous(),
                              trim_norm.pcs.contiguous(), serving)
    kernels.append(compare_minplus(torch, norm))
    kernels.append(compare_fps(torch))
    kernels.extend(compare_icp(torch))
    del norm, trim_norm
    torch.cuda.empty_cache()

    # Phases 3 to 7: the main paths through register(Config) and GoICP.
    counted = (cuda_nn.nn_argmin, cuda_nn.nn_min,
               cuda_bounds.fused_bounds_lanes,
               cuda_bounds.fused_bounds_lanes_trimmed,
               cuda_bounds.fused_bounds, cuda_minplus.minplus_1d,
               cuda_fps.farthest_point_sample, cuda_icp.icp_align,
               cuda_icp.icp_commit)
    launches = {fn.__name__: 0 for fn in counted}
    nn_fns = (cuda_nn.nn_argmin, cuda_nn.nn_min)

    def reset():
        for fn in counted:
            fn.launches = 0
        for fn in nn_fns:
            fn.shapes.clear()

    def nn_shapes():
        """The NN kernels' launches per (M, T) since the last reset."""
        return {fn.__name__: {f"{m}x{t}": n for (m, t), n in
                              sorted(fn.shapes.items())} for fn in nn_fns}

    def drive(label, cfg, pct_in, pcs_in, truth, **engine):
        """Cold then warm register(); returns each run's launches."""
        for key, value in engine.items():
            setattr(cfg.engine, key, value)
        out = {}
        for run in ("cold", "warm"):
            reset()
            t_run = time.time()
            model, R, t = register(cfg, pct_in, pcs_in, device="cuda")
            torch.cuda.synchronize()
            wall = time.time() - t_run
            launched = {fn.__name__: fn.launches for fn in counted}
            for key, n in launched.items():
                launches[key] += n
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
                f"launches {launched}, NN launches by shape {nn_shapes()}")
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

    default = drive("default", cfg, pct_in, pcs_in, pair,
                    icp_multi_start=True)
    require("default", default,
            ["farthest_point_sample", "icp_align", "icp_commit"], nodes=False)
    search = drive("search-only", cfg, pct_in, pcs_in, pair,
                   icp_multi_start=False)
    require("search-only", search,
            ["nn_argmin", "nn_min", "fused_bounds_lanes",
             "farthest_point_sample", "icp_align", "icp_commit"])

    tdefault = drive("trimmed default", tcfg, tpct_in, tpcs_in, trim_pair,
                     icp_multi_start=True)
    require("trimmed default", tdefault,
            ["farthest_point_sample", "icp_align", "icp_commit"], nodes=False)
    tsearch = drive("trimmed search-only", tcfg, tpct_in, tpcs_in, trim_pair,
                    icp_multi_start=False)
    require("trimmed search-only", tsearch,
            ["nn_argmin", "nn_min", "fused_bounds_lanes_trimmed",
             "farthest_point_sample"])

    grouped = drive("grouped search-only", cfg, pct_in, pcs_in, pair,
                    icp_multi_start=False, frontier_mode="grouped")
    require("grouped search-only", grouped,
            ["nn_argmin", "nn_min", "fused_bounds"])
    cfg.engine.frontier_mode = "pooled"

    lut_phase(torch, dev, pair, counted, launches, reset, nn_shapes)
    # Phase 8 runs no user entry point: its launches are not counted.
    bunny_field_phase(torch, dev)
    srv = serving_phase(torch, dev, serving, counted, launches, reset,
                        nn_shapes, smi_line)

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
    checkpoint_phase(torch, dev, pair, counted, launches, reset,
                     host_model.best_sse, host_model.stats.outer_steps)
    many = overflow_phase(torch, dev, pair, counted, launches, reset,
                          host_model.best_sse)

    # Phase 11: the multi-host outer BnB, threads and processes.
    multihost_phase(torch, dev, pair, counted, launches, reset, many,
                    smi_line)

    # Phase 12: the device mesh, gloo processes sharing this card.
    served = srv.register(serving["sources"])
    refs = dict(smoke=search, grouped=grouped, trimmed=tsearch,
                device=dsearch)
    mesh_phase(torch, launches,
               {k: r["warm"]["model"] for k, r in refs.items()},
               {k: r["warm"]["wall"] for k, r in refs.items()}, served,
               serving, smi_line)

    # Phase 13: hosts on meshes, gloo processes sharing this card.
    hostmesh_phase(launches, many, smi_line)

    # Phase 14: the merge update, the CLI's --profile / --debug-nans and
    # the kernel gate.
    merge_phase(drive, require, cfg, pct_in, pcs_in, pair,
                {"host": search, "device": dsearch}, smi_line)
    cli_phase(smi_line)
    kernel_check_phase(smi_line)

    # Phase 15: the experiment tools.
    tools_phase(torch, counted, launches, reset,
                tsearch["warm"]["model"].stats.translation_nodes, smi_line)

    for krow in kernels:
        krow["launches"] = launches[krow["name"]]
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
