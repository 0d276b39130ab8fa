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
     clusters against the shared 1,024-point coreset);
  3. run the default main path, `register(Config)` on cuda, on a seeded
     asymmetric 18,000 / 3,000-point pair with a known pose: it must
     certify (last_certified_gap <= sse_threshold) and recover the pose
     (R max-abs error < 5e-3, t error < 5e-3 x span); cold, then warm;
  4. the same with icp_multi_start = false, the search-only form of the
     path, which must also bound translation nodes and launch the NN and
     lane kernels;
  5. trimmed registration (trim = true, trim_fraction = 0.3) on a seeded
     partial-overlap pair (20,000 target / 10,000 source points, 22.5 % of
     the source outside the target's part of the curve), default and
     search-only; both must certify and recover the pose, and the
     search-only run must launch the trimmed lane kernel;
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
     loop, walls, counters and the device loop's host reads side by side;
     10c both checkpoint kinds: a search-only run with checkpoint_every = 1
     into build/chip_smoke/ killed after its second checkpoint (the host
     loop's first when it takes one step) and resumed by a fresh GoICP with
     debug_checks = True, certified at the known pose and phase 4's
     optimum; 10d an overflowing frontier (so3_capacity = 8 x
     rotation_batch, OVERFLOW_ENGINE): the device gap must end open, the
     host loop re-certify and close it within sse_threshold of phase 4's
     optimum; then the same engine's many-step search in both outer modes.
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
    loop's; walls, counters and the device loop's host reads side by
    side."""
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
        f"{hs.icp_runs}; device-loop host reads per run {dw['host_reads']}; "
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
    side by side, a search of many outer steps."""
    from fgoicp_tpu_torch import EngineConfig, GoICP
    from fgoicp_tpu_torch.ops import so3_frontier

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
        f"device-loop host reads {so3_frontier.so3_bnb_device.host_reads}, "
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

    walls = {}
    for mode in ("device", "host"):
        for _ in range(2):
            so3_frontier.so3_bnb_device.host_reads = 0
            t_run = time.time()
            model = make(outer_mode=mode, so3_capacity=16384)
            model.run()
            torch.cuda.synchronize()
            walls[mode] = (time.time() - t_run, model.stats.outer_steps,
                           model.stats.translation_nodes, model.best_sse,
                           so3_frontier.so3_bnb_device.host_reads)
            if not model.last_certified_gap <= model.sse_threshold:
                raise AssertionError(f"many-step {mode}: not certified")
    say(f"many-step search (OVERFLOW_ENGINE, so3_capacity 16384), second "
        f"run of each: (wall s, outer_steps, translation_nodes, best_sse, "
        f"device-loop host reads) device {walls['device']!r}, host "
        f"{walls['host']!r}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA GPU", file=sys.stderr)
        return 1

    from fgoicp_tpu_torch import register
    from fgoicp_tpu_torch.kernels import build
    from fgoicp_tpu_torch.ops import cuda_bounds, cuda_minplus, cuda_nn
    from fgoicp_tpu_torch.ops import geometry as geo
    from fgoicp_tpu_torch.ops import so3_frontier

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
    del norm, trim_norm
    torch.cuda.empty_cache()

    # Phases 3 to 7: the main paths through register(Config) and GoICP.
    counted = (cuda_nn.nn_argmin, cuda_nn.nn_min,
               cuda_bounds.fused_bounds_lanes,
               cuda_bounds.fused_bounds_lanes_trimmed,
               cuda_bounds.fused_bounds, cuda_minplus.minplus_1d)
    launches = {fn.__name__: 0 for fn in counted}
    nn_fns = (cuda_nn.nn_argmin, cuda_nn.nn_min)

    def reset():
        for fn in counted:
            fn.launches = 0
        for fn in nn_fns:
            fn.shapes.clear()
        so3_frontier.so3_bnb_device.host_reads = 0

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
            host_reads = so3_frontier.so3_bnb_device.host_reads
            r_err, t_err = pose_errors(R, t, truth)
            s = model.stats
            say(f"{label} {run}: wall {wall!r} s (register), run "
                f"{s.wall_seconds!r} s, best_sse {model.best_sse!r}, gap "
                f"{model.last_certified_gap!r} <= {model.sse_threshold!r}, "
                f"R err {r_err!r}, t err/span {t_err!r}, translation_nodes "
                f"{s.translation_nodes}, rotation_children "
                f"{s.rotation_children}, outer_steps {s.outer_steps}, "
                f"inner_loop_steps {s.inner_loop_steps}, icp_runs "
                f"{s.icp_runs}, device-loop host reads {host_reads}, "
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

    drive("default", cfg, pct_in, pcs_in, pair, icp_multi_start=True)
    search = drive("search-only", cfg, pct_in, pcs_in, pair,
                   icp_multi_start=False)
    require("search-only", search,
            ["nn_argmin", "nn_min", "fused_bounds_lanes"])

    drive("trimmed default", tcfg, tpct_in, tpcs_in, trim_pair,
          icp_multi_start=True)
    tsearch = drive("trimmed search-only", tcfg, tpct_in, tpcs_in, trim_pair,
                    icp_multi_start=False)
    require("trimmed search-only", tsearch,
            ["nn_argmin", "nn_min", "fused_bounds_lanes_trimmed"])

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
    overflow_phase(torch, dev, pair, counted, launches, reset,
                   host_model.best_sse)

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
    n_launch = sum(e.count for e in averages
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    mine = [e for e in events if kernel in e.key]
    say(f"profile {label} (warm): wall {wall!r} s, device busy "
        f"{busy_us / 1e6!r} s ({100 * busy_us / 1e6 / wall!r} %), kernel "
        f"launches {n_launch}; {kernel}: "
        f"{sum(e.self_device_time_total for e in mine) / 1e3!r} ms of device "
        f"time in {sum(e.count for e in mine)} launches")
    say(averages.table(sort_by="self_device_time_total", row_limit=15,
                       max_name_column_width=60))


if __name__ == "__main__":
    sys.exit(main())
