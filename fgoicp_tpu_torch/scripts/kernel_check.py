"""The kernel gate: every hand-written CUDA kernel of the port held against
its plain torch version on the card, in one place.

    python -m fgoicp_tpu_torch.scripts.kernel_check [--grid full|reduced]
        [--device cuda] [--out build/kernel_check.json]

Two ways in, one comparison per kernel kind (`hold`):
* the grid (`run_check`), synthetic operating points:
  - `fused_bounds_lanes` at proxy P {1,024, 4,096} x ns {512, 1,024, 1,536,
    2,048, 3,037, 10,240} (source clusters of a synthetic bunny-size scan);
    `fused_bounds_lanes_trimmed` at keep 2,126 / 3,037, 2,733 / 3,037,
    7,168 / 10,240 and 21,000 / 30,000 (its terms in a scratch), the first
    also against the unfused path; `fused_bounds` on a G 16 x B 32 grid at
    ns 3,037; `nn_min` and `nn_argmin` on 8,192 anchor queries against the
    4,096 proxies, the argmin winner rescored; `minplus_1d` on seeded lines
    at the three pass lengths of a 0.002 field;
  - the device mesh's shard shapes: lanes at G 256, L 1,024, ns 512, P
    1,024; the grid at G 256, B 32, ns 1,500, P 1,024; `nn_argmin` 48,000 x
    9,000 and `nn_min` 24,000 x 9,000;
  - edge cases (`_nn_edges`, `_bounds_edges`, `_minplus_lines`): the NN
    kernels at M {1, 127, 129} x T {1, 1023, 1025, 2049}, on a lattice
    listed three times whose tied copies fall in different target slices
    (exact hits on the first copy), with every d2 above BIG, and more than
    one slice planned at the polish shape; the three bound kernels at P
    {1, 31, 33, 1024, 2049} x ns {1, 129, 3000}, on box faces and corners,
    with 33 copies of one proxy split across buckets and every d2 above
    BIG, each also bit for bit with one-hot point weights (`_one_hot`);
    `minplus_1d` on seeded, constant, negative and few-valued lines;
  - `farthest_point_sample` at the main paths' (n, k): 17,953 -> 1,024,
    3,037 -> 1,024, 8,000 -> 2,048, 6,000 -> 4,096 and 6,000 -> 1,024 (the
    first n points of the synthetic target), with its us a step and its
    latency bound, k - 1 steps at its step at n = 1;
  - `icp_align` + `nn_argmin` + `icp_commit` at the main paths' (lanes,
    points, target points) with their callers' convergence thresholds
    (ICP_SHAPES), every iteration of the plain loop until its lanes stop,
    each step also taken on the kernels from the same state
    (`compare_icp_steps`); the two kernels' device time a launch by the
    profiler (`device_us`) and the host's ms an iteration;
  - `pool_commit` on a seeded mid-search pool (`pool_commit_args`) at the
    search cell's G 256, L 1,024, CP 32,768, and at G 6, L 64, CP 64 (every
    slot a lane, the children overflow): every output bit for bit, with
    its device time a launch and its byte bound (`cuda_pool.traffic`);
* the recorder (`Recorder`): while installed, the wrappers of RECORDED keep
  the arguments of their first launch at each distinct shape as the
  program gives them, and `check` then holds each.  chip_smoke.py records
  its main paths, serving, meshes and tools this way.
Tolerances: NN, FPS indices, `pool_commit` and `minplus_1d` bit for bit
(and the argmin winner's rescore equal to its d2); bounds finite, rtol 2e-4 /
atol 2e-5, lb <= ub; the ICP step's R, t, last_R, last_t and moved points
within 2e-5, its SSE within rtol 1e-4 (the kernels sum in another order than
torch), last_sse and the lanes already done bit for bit, `done` and
`running` equal but where rounding may decide the loop guard, and the
guard must fire.

Each row: kernel, shape, ok, max_abs_err; on the card the kernel's mean
ms (CUDA events), one plain call's ms, the bound (the larger of flops at
the H100's f32 peak and bytes at its HBM peak; for the pruned kernels of
the work their counters report, `work`, with the full scan's beside it)
and, where torch.cdist can form the [M, T] matrix, the library's ms.
`--grid reduced` keeps one point of each family, `tiny` shrinks every
shape (the CPU tests).  On the CPU the wrappers run their plain versions,
so the gate holds plain against plain and times nothing.

Prints one JSON object; writes it to --out only.  Exits 0 when every row
passes.
"""

from __future__ import annotations

import argparse
import copy
import inspect
import json
import os
import sys
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet, 700 W): float32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# The H100 SXM's SMs and its instruction-issue rate: one warp instruction
# per clock on each of 4 x 132 schedulers at the 1.98 GHz boost clock.  With
# --fmad=false every sub, mul, add and min of a distance issues on its own:
# the NN kernels issue about 9.25 (nn_min) and 9.75 (nn_argmin)
# instructions per (query, target) pair.
SMS = 132
INSTR_RATE = SMS * 4 * 32 * 1.98e9
NN_INSTRS = {"nn_min": 9.25, "nn_argmin": 9.75}
# The pruned bound kernels (csrc/bounds_terms.cuh): 9.25 issues per (point,
# proxy) pair evaluated, as nn_min, and about 19 per (point, box) test;
# their bound counts 8 flops a pair (3 sub, 3 mul, 2 add) and 17 a box test
# (6 sub, 6 max, 3 mul, 2 add), the compare and the min left out of both.
PAIR_INSTRS, BOX_INSTRS = 9.25, 19.0
PAIR_FLOPS, BOX_FLOPS = 8.0, 17.0
# The FPS kernel's work a (point, step): 3 sub, 3 mul, 2 add and the min,
# and about 17 issued instructions with the loads, the store and the
# compare (csrc/fps.cu).  One block walks every step on one SM; its latency
# bound is k - 1 times its step at n = 1 (FPS_FLOOR_K steps), which is a
# block barrier and two warp reductions with no point to update.
FPS_OPS, FPS_INSTRS = 9.0, 17.0
FPS_FLOOR_K = 4096
BOUND_KERNELS = ("fused_bounds_lanes", "fused_bounds_lanes_trimmed",
                 "fused_bounds")
# The wrappers the recorder swaps (their modules from utils/trace.py's list
# of wrappers).  FPS is imported by name where it is called, and the ICP
# kernels update their arguments in place: both are grid rows only.
RECORDED = ("nn_argmin", "nn_min") + BOUND_KERNELS + ("minplus_1d",)
# The most distinct launch shapes the recorder keeps per (label, kernel),
# the first seen.
MAX_SHAPES = 12

# The ICP kernels' main-path shapes, (lanes, points a lane, target points,
# the caller's convergence threshold, config.py's EngineConfig): the bunny
# seeding lanes on the 1,024-point coreset (icp_convergence_init), the
# width-1 bunny polish (icp_convergence_final), the serving seeding, 480
# lanes of 2,048 on the 4,096-point coreset (icp_convergence_bnb), and the
# serving polish, 32 views of 8,000 on the 6,000-point target
# (icp_convergence_final).
ICP_SHAPES = ((15, 1024, 1024, 0.05), (1, 3037, 17953, 5e-4),
              (480, 2048, 4096, 5e-3), (32, 8000, 6000, 5e-4))
# The ICP kernels against their plain versions (tests/test_torch_icp_kernel.py
# gives the reasons): poses and moved points within ICP_ATOL, the SSE within
# rtol ICP_SSE_RTOL, and `done` equal except where the plain step's
# relative improvement lies within ICP_GUARD_BAND of the threshold.
ICP_ATOL, ICP_SSE_RTOL, ICP_GUARD_BAND = 2e-5, 1e-4, 1e-5
ICP_MAX_STEPS = 100
# pool_commit's (groups, lanes, slots, valid slots): the search cell's
# pooled step, and every slot a lane with the children overflowing.
COMMIT_SHAPES = ((256, 1024, 32768, 20000), (6, 64, 64, 60))
# Iterations the host clock times an ICP iteration over.
ICP_ITERATIONS = 20

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(_ROOT, "build", "kernel_check.json")

# The edge cases of the full and reduced grids: NN queries M x targets T, the
# lattice side of the duplicated grid, the far-away (queries, targets); the
# bound kernels' P x ns, the box lattice side, the duplicated proxy's case
# (source points, proxies before, proxies after the copies), the far-away
# (points, proxies); minplus (lines, n) of seeded lines, and of the kinds.
EDGES = dict(nn_m=(1, 127, 129), nn_t=(1, 1023, 1025, 2049), lattice=16,
             far=(700, 5000), bounds_p=(1, 31, 33, 1024, 2049),
             bounds_ns=(1, 129, 3000), box_lattice=8, dup=(200, 100, 30),
             far_bounds=(300, 700), lines=((1, 1), (7, 2047), (1000, 333)),
             kinds=(1000, 333))
# name -> (target points, source pool points, proxies, lane ns, trimmed
# (ns, keep), grid (G, B, ns, P), NN anchors (queries, proxies), minplus
# (lines, n), shard lanes (G, L, ns, P), shard grid (G, B, ns, P), shard NN
# argmin (M, T), shard NN min (M, T), FPS (n, k) pairs, ICP (lanes, ns, nt,
# convergence threshold), pool_commit (G, L, CP, valid slots), the polish
# (M, T) whose slice plan is checked, edge cases).
GRIDS = {
    "full": dict(
        nt=18000, pool=20000, proxies=(1024, 4096),
        ns=(512, 1024, 1536, 2048, 3037, 10240),
        trimmed=((3037, 2126), (3037, 2733), (10240, 7168), (30000, 21000)),
        grid=(16, 32, 3037, 1024), anchors=(8192, 4096),
        minplus=((4096, 348), (4096, 584), (4096, 828)),
        shard_lanes=(256, 1024, 512, 1024), shard_grid=(256, 32, 1500, 1024),
        shard_argmin=(48000, 9000), shard_min=(24000, 9000),
        fps=((17953, 1024), (3037, 1024), (8000, 2048), (6000, 4096),
             (6000, 1024)),
        icp=ICP_SHAPES, commit=COMMIT_SHAPES, polish=(3000, 18000),
        edges=EDGES),
    "reduced": dict(
        nt=18000, pool=20000, proxies=(1024,), ns=(512, 3037),
        trimmed=((3037, 2126), (30000, 21000)), grid=(16, 32, 3037, 1024),
        anchors=(8192, 4096), minplus=((4096, 828),),
        shard_lanes=(256, 1024, 512, 1024), shard_grid=(256, 32, 1500, 1024),
        shard_argmin=(48000, 9000), shard_min=(24000, 9000),
        fps=((17953, 1024), (3037, 1024)),
        icp=(ICP_SHAPES[0], ICP_SHAPES[2]), commit=COMMIT_SHAPES,
        polish=(3000, 18000), edges=EDGES),
    "tiny": dict(
        nt=600, pool=400, proxies=(32,), ns=(48,), trimmed=((64, 45),),
        grid=(4, 4, 64, 32), anchors=(128, 32), minplus=((16, 20),),
        shard_lanes=(8, 16, 32, 32), shard_grid=(4, 4, 48, 32),
        shard_argmin=(64, 90), shard_min=(48, 90), fps=((600, 32), (90, 16)),
        icp=((3, 48, 90, 0.05),), commit=((6, 16, 64, 40), (6, 16, 16, 12)),
        polish=(3000, 18000),
        edges=dict(nn_m=(1, 5), nn_t=(1, 33), lattice=8, far=(20, 50),
                   bounds_p=(1, 33), bounds_ns=(1, 33), box_lattice=3,
                   dup=(20, 10, 3), far_bounds=(10, 20),
                   lines=((1, 1), (7, 65), (20, 33)), kinds=(20, 33))),
}
LANES, GROUPS = 64, 6


def _cuda(device) -> bool:
    import torch
    return torch.device(device).type == "cuda"


def cuda_ms(fn, device, reps: int = 10):
    """Mean milliseconds a call on the card: a warm-up, then CUDA events
    around `reps` calls queued back to back (a kernel shorter than its
    wrapper's host time reads as the host's time); None off the card."""
    if not _cuda(device):
        return None
    import torch
    fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / reps


def timed_once(fn, device):
    """(fn(), its milliseconds by CUDA events on the card, or None)."""
    if not _cuda(device):
        return fn(), None
    import torch
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize(device)
    return out, start.elapsed_time(stop)


def device_us(call, kernels, device, reps: int = 20):
    """Mean device microseconds a launch of each named kernel over `reps`
    warm calls of call(), from torch.profiler's device events; None off the
    card."""
    if not _cuda(device):
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize(device)
    out = {}
    for name in kernels:
        events = [e for e in prof.key_averages() if name in e.key
                  and str(getattr(e, "device_type", "")).endswith("CUDA")]
        n = sum(e.count for e in events)
        out[name] = (sum(e.self_device_time_total for e in events) / n
                     if n else None)
    return out


def bound(flops, nbytes):
    """(ms, "operations" | "bytes"): the least time the card could take,
    the larger of flops at the f32 peak and bytes at the HBM peak."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# The timing and bound fields of every row, None off the card.
FIELDS = ("ms", "plain_ms", "bound_ms", "bound_by", "full_scan_bound_ms",
          "work", "library_ms")


def row(kernel, shape, ok, err, **fields):
    """One row of the gate: kernel, shape, ok, max_abs_err, FIELDS and any
    extra fields."""
    return {"kernel": kernel, "shape": shape, "ok": bool(ok),
            "max_abs_err": float(err), **dict.fromkeys(FIELDS), **fields}


def describe(r) -> str:
    """One row as a line of text, the fields that are None left out."""
    head = f"{r['label']}: " if r.get("label") else ""
    rest = [k for k in r if k not in ("label", "kernel", "shape", "ok",
                                      "max_abs_err")]
    return (f"{head}{r['kernel']} [{r['shape']}]: "
            f"{'OK' if r['ok'] else 'MISMATCH'}, max_abs_err "
            f"{r['max_abs_err']!r}"
            + "".join(f", {k} {r[k]!r}" for k in rest if r[k] is not None))


def nn_plan(device, m: int, t: int):
    """The NN kernels' (slices, chunk) for M x T: the card's own plan, or
    the H100's (SMS) off the card."""
    import torch
    from ..ops import cuda_nn
    device = torch.device(device)
    if device.type == "cuda":
        return cuda_nn._plan(device, m, t)
    return cuda_nn.plan_splits(m, t, SMS)


def _arguments(fn, args, kw):
    a = inspect.signature(fn).bind(*args, **kw)
    a.apply_defaults()
    return a.arguments


def _describe(fn, args, kw):
    """How to hold one wrapper call: a dict of its plain call, shape text,
    the full scan's flops, bytes and issued instructions (None: not
    counted), the counted launch (launch(counts) runs the kernel with its
    int64 [2] counters, for the pruned kernels) and flops besides the
    search (the trimmed kernel's bisection: 27 compare passes over both
    term arrays); for the NN kernels also their slice plan and the library
    call, torch.cdist then the min, where its [M, T] matrix has fewer than
    2^31 elements."""
    import torch
    from ..ops import cuda_bounds, cuda_fps, cuda_minplus, cuda_nn, cuda_pool
    a = _arguments(fn, args, kw)
    name = fn.__name__
    if name in NN_INSTRS:
        q, p = a["queries"], a["points"]
        m, t = q.shape[0], p.shape[0]
        plain = getattr(cuda_nn, name + "_plain")
        reduce = ((lambda d: torch.min(d, dim=1)) if name == "nn_argmin"
                  else (lambda d: torch.amin(d, dim=1)))
        return dict(plain=lambda: plain(q, p), shape=f"{m}x{t}",
                    flops=8.0 * m * t,
                    nbytes=12.0 * (m + t) + 4 * m * (
                        2 if name == "nn_argmin" else 1),
                    instrs=NN_INSTRS[name] * m * t, counted=None, extra=0.0,
                    plan=nn_plan(q.device, m, t),
                    library=None if m * t >= 2 ** 31 else lambda: reduce(
                        torch.cdist(q, p, compute_mode=(
                            "donot_use_mm_for_euclid_dist"))))
    if name == "minplus_1d":
        g, res = a["g"], a["res"]
        lines, n = g.shape
        return dict(plain=lambda: cuda_minplus.minplus_1d_plain(g, res),
                    shape=f"{lines}x{n}", flops=2.0 * lines * n * n,
                    nbytes=8.0 * lines * n, instrs=None,
                    counted=lambda c: cuda_minplus._launch(g, res, c),
                    extra=0.0)
    if name == "pool_commit":
        st, buf = a["s"], a["buf"]
        g, cp, nl = st.best_err.shape[0], st.lbs.shape[0], buf.gam_t.shape[0]

        def outputs(commit):
            # Every state tensor and what the commit writes into a copy of
            # the buffers.
            b = copy.copy(buf)
            b.lane_gid, b.gam_t, b.live = (
                x.clone() for x in (buf.lane_gid, buf.gam_t, buf.live))
            new = commit(st, a["lb_e"], a["ub_e"], a["share"], a["min_span"],
                         a["sse_threshold"], b)
            return tuple(getattr(new, f) for f in new._fields
                         if f != "steps") + (b.lane_gid, b.gam_t, b.live)
        return dict(plain=lambda: outputs(cuda_pool.pool_commit_plain),
                    call=lambda: outputs(fn), shape=f"G{g} L{nl} CP{cp}",
                    flops=0.0, nbytes=cuda_pool.traffic(g, cp, nl),
                    instrs=None, counted=None, extra=0.0)
    if name == "farthest_point_sample":
        p, k, seed = a["points"], a["k"], a["seed"]
        n = p.shape[0]
        return dict(
            plain=lambda: cuda_fps.farthest_point_sample_plain(p, k, seed),
            shape=f"{n}->{k}", flops=FPS_OPS * n * (k - 1),
            nbytes=12.0 * n + 8.0 * k, instrs=None, counted=None, extra=0.0)
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
            base, tc, a["gam_ub"], gam_lb, a["gam_t"], w, slack, buckets,
            order, c)
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
    return dict(plain=plain, shape=shape,
                flops=PAIR_FLOPS * lanes * ns * n_prox + extra,
                nbytes=4.0 * (base.numel() + 2 * base.shape[0] * ns + ns
                              + 3 * n_prox + 5 * lanes + 2 * lanes),
                instrs=PAIR_INSTRS * lanes * ns * n_prox, counted=counted,
                extra=extra)


def compare(name, got, want):
    """(ok, max abs error) of a kernel's outputs against its plain
    version's: bounds finite, within rtol 2e-4 / atol 2e-5, lb <= ub; every
    other kernel bit for bit."""
    import torch
    if name in BOUND_KERNELS:
        (lb, ub), (lb_p, ub_p) = got, want
        err = max(float(torch.max(torch.abs(lb - lb_p))),
                  float(torch.max(torch.abs(ub - ub_p))))
        ok = (bool(torch.all(torch.isfinite(lb)))
              and bool(torch.all(torch.isfinite(ub)))
              and torch.allclose(lb, lb_p, rtol=2e-4, atol=2e-5)
              and torch.allclose(ub, ub_p, rtol=2e-4, atol=2e-5)
              and bool(torch.all(lb <= ub)))
        return ok, err
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    ok = all(torch.equal(k, p) for k, p in zip(got, want))
    err = (float(torch.max(torch.abs(got[0] - want[0])))
           if got[0].numel() else 0.0)
    return ok, err


def _counters(launch, device):
    """[pairs or triples, box tests or staged chunks] of one counted
    launch, from the kernel's int64 [2] counters."""
    import torch
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    launch(counts)
    torch.cuda.synchronize(device)
    return [int(v) for v in counts.cpu()]


def hold(fn, args, kw=None, prefix=""):
    """One wrapper call against its plain version (`compare`): the row
    (`row`) with the plain call's ms (one call), the kernel's (`cuda_ms`),
    the bound of the counted work where the kernel counts it and the full
    scan's beside it, the issue ceiling of that work, and for the NN
    kernels their slice plan and the library's ms (`_describe`)."""
    kw = kw or {}
    name = fn.__name__
    how = _describe(fn, args, kw)
    device = next(a.device for a in args if hasattr(a, "device"))
    want, plain_ms = timed_once(how["plain"], device)
    ok, err = compare(name, how["call"]() if "call" in how
                      else fn(*args, **kw), want)
    del want
    full_ms, bound_by = bound(how["flops"], how["nbytes"])
    fields = dict(plain_ms=plain_ms, full_scan_bound_ms=full_ms,
                  bound_ms=full_ms, bound_by=bound_by)
    instrs = how["instrs"]
    if how["counted"] is not None and _cuda(device):
        work = _counters(how["counted"], device)
        if name == "minplus_1d":
            done, instrs = 2.0 * work[0], 2.0 * work[0]
        else:
            done = PAIR_FLOPS * work[0] + BOX_FLOPS * work[1] + how["extra"]
            instrs = PAIR_INSTRS * work[0] + BOX_INSTRS * work[1]
        fields["bound_ms"], fields["bound_by"] = bound(done, how["nbytes"])
        fields["work"] = work
    if instrs is not None:
        fields["issue_ms"] = instrs / INSTR_RATE * 1e3
    if "plan" in how:
        fields["plan"] = how["plan"]
    if how.get("library") is not None:
        try:
            fields["library_ms"] = cuda_ms(how["library"], device, 1)
        except RuntimeError as exc:
            fields["library_refused"] = str(exc)[:200]
    return row(name, prefix + how["shape"], ok, err,
               ms=cuda_ms(lambda: fn(*args, **kw), device), **fields)


def _shape_key(a):
    """What makes a kernel argument's launch shape: a tensor's shape and
    dtype, a bucket set's proxy count, an int's value (n_drop)."""
    if hasattr(a, "shape"):
        return tuple(a.shape), str(a.dtype)
    if hasattr(a, "points"):
        return "buckets", tuple(a.points.shape)
    return a if isinstance(a, (int, type(None))) else type(a).__name__


class Recorder:
    """While installed (`with recorder.record(label):`), the wrappers of
    RECORDED keep a copy of the arguments of their first launch at each
    distinct shape (up to MAX_SHAPES a kernel and label), as the program
    gives them; `check` then holds each against its plain version (`hold`).
    The wrappers' module attributes are swapped for forwarding objects, so
    the ops and the wrappers' own `launches` and `shapes` counting see the
    same functions; leaving the block puts the wrappers back."""

    def __init__(self):
        import importlib
        from ..utils import trace
        self.mods = {name: importlib.import_module(module)
                     for module, names in trace.LAUNCH_COUNTERS
                     for name in names if name in RECORDED}
        self.calls = {}   # (label, name, shapes) -> (fn, args, kwargs)
        self.shapes = {}  # (label, name) -> distinct launch shapes seen
        self.label = ""

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
                if key not in outer.calls and len(seen) <= MAX_SHAPES:
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

    def check(self):
        """Every recorded launch held (`hold`), one row a launch shape with
        its `label` and the number of distinct shapes its label launched
        the kernel at (`of`); forgets them."""
        out = []
        for (label, name, _, _), (fn, args, kw) in self.calls.items():
            out.append(dict(hold(fn, args, kw), label=label,
                            of=len(self.shapes[(label, name)])))
        self.calls.clear()
        self.shapes.clear()
        return out


def icp_state(pct, pcs, R0, t0, active=None):
    """`models/icp.py::icp_batched`'s loop state before its first
    iteration: the points moved by (R0, t0), their NN query, R / t and
    last_R / last_t at the start, sse BIG and last_sse 2 BIG, `done` the
    inactive lanes, `running` the active count."""
    import torch
    from ..models import icp as ticp
    from ..ops import cuda_nn
    g, ns, dev = R0.shape[0], pcs.shape[-2], pct.device
    if active is None:
        active = torch.ones(g, dtype=torch.bool, device=dev)
    cur = ticp._transform(R0, pcs, t0).contiguous()
    d2, idx = cuda_nn.nn_argmin(cur.reshape(-1, 3), pct)
    return dict(cur=cur, d2=d2.reshape(g, ns), idx=idx.reshape(g, ns),
                R=R0.clone(), t=t0.clone(), last_R=R0.clone(),
                last_t=t0.clone(),
                sse=torch.full((g,), ticp.BIG, device=dev),
                last_sse=torch.full((g,), 2 * ticp.BIG, device=dev),
                done=~active,
                running=torch.sum(active, dtype=torch.int32).reshape(1))


def icp_step(s, pct, threshold, weights=None, trim=None, kernels=True):
    """One iteration of icp_batched's loop on state s, in place: icp_align,
    the NN query, icp_commit (`ops/cuda_icp.py`; kernels=False: their
    plain versions, on any device)."""
    from ..models import icp as ticp
    from ..ops import cuda_icp, cuda_nn
    align = cuda_icp.icp_align if kernels else cuda_icp.icp_align_plain
    commit = cuda_icp.icp_commit if kernels else cuda_icp.icp_commit_plain
    g, ns = s["idx"].shape
    align(pct, s["idx"], ticp.trim_mask(s["d2"], trim, weights), s["done"],
          s["cur"], s["R"], s["t"], s["last_R"], s["last_t"], s["running"])
    d2, idx = cuda_nn.nn_argmin(s["cur"].reshape(-1, 3), pct)
    s["d2"], s["idx"] = d2.reshape(g, ns), idx.reshape(g, ns)
    if ticp._trimmed(trim, ns):
        commit(ticp.trimmed_sum(s["d2"], trim)[:, None], None, threshold,
               s["done"], s["sse"], s["last_sse"], s["running"])
    else:
        commit(s["d2"], weights, threshold, s["done"], s["sse"],
               s["last_sse"], s["running"])


def compare_icp_steps(pct, pcs, R0, t0, threshold, active=None,
                      weights=None, trim=None, max_steps=ICP_MAX_STEPS):
    """icp_batched's loop on the plain versions from icp_state, up to
    max_steps or until no lane runs; before each plain step a copy of the
    state takes the step on the kernels, and every output of both is
    compared.  Returns the worst readings over the steps: `pose_err` (max
    abs of R, t and the moved points), `last_err` (last_R, last_t),
    `sse_rel_err`; `last_sse_equal`, `done_ok` (equal but within
    ICP_GUARD_BAND of the threshold), `running_ok` (each side's running =
    its lanes not done), `done_lanes_kept` (lanes done before a step left
    bit for bit); `steps`, `guard_fired` (lanes the plain guard finished)
    and `ok`: every reading within its limit and the guard fired."""
    import torch
    s = icp_state(pct, pcs, R0, t0, active)
    out = dict(pose_err=0.0, last_err=0.0, sse_rel_err=0.0,
               last_sse_equal=True, done_ok=True, running_ok=True,
               done_lanes_kept=True, steps=0, guard_fired=0)

    def worst(key, value):
        value = float(value)
        out[key] = max(out[key], value) if value == value else float("inf")

    while out["steps"] < max_steps and int(s["running"][0]) > 0:
        was = s["done"].clone()
        k = {key: v.clone() for key, v in s.items()}
        icp_step(k, pct, threshold, weights, trim)
        before = {key: v.clone() for key, v in s.items()}
        icp_step(s, pct, threshold, weights, trim, kernels=False)
        worst("pose_err", max(float(torch.max(torch.abs(k[x] - s[x])))
                              for x in ("R", "t", "cur")))
        worst("last_err", max(float(torch.max(torch.abs(k[x] - s[x])))
                              for x in ("last_R", "last_t")))
        worst("sse_rel_err", torch.max(torch.abs(k["sse"] - s["sse"])
                                       / s["sse"]))
        out["last_sse_equal"] &= torch.equal(k["last_sse"], s["last_sse"])
        rel = (s["last_sse"] - s["sse"]) / s["last_sse"]
        differ = k["done"] != s["done"]
        out["done_ok"] &= bool(torch.all(
            torch.abs(rel[differ] - threshold) <= ICP_GUARD_BAND))
        out["running_ok"] &= all(
            int(side["running"][0]) == int((~side["done"]).sum())
            for side in (k, s))
        out["done_lanes_kept"] &= all(
            torch.equal(k[x][was], before[x][was])
            for x in ("cur", "R", "t", "last_R", "last_t", "sse",
                      "last_sse"))
        out["guard_fired"] += int((s["done"] & ~was).sum())
        out["steps"] += 1
    out["ok"] = (out["pose_err"] <= ICP_ATOL and out["last_err"] <= ICP_ATOL
                 and out["sse_rel_err"] <= ICP_SSE_RTOL
                 and out["last_sse_equal"] and out["done_ok"]
                 and out["running_ok"] and out["done_lanes_kept"]
                 and out["guard_fired"] > 0)
    return out


def _icp_row(target, src, R0, t0, threshold):
    """The ICP iteration's row: `compare_icp_steps` at the caller's
    threshold; on the card the two kernels' and their plain versions' ms a
    call (icp_commit at threshold -1, so no lane finishes while it is
    timed), their bound (`cuda_icp.traffic`), each kernel's device time a
    launch (`device_us`) and the host clock's ms an iteration (align, NN,
    commit, the read of `running`) over ICP_ITERATIONS iterations, on the
    kernels and on the plain versions."""
    from ..ops import cuda_icp
    g, ns, nt = R0.shape[0], src.shape[0], target.shape[0]
    dev = target.device
    out = compare_icp_steps(target, src, R0, t0, threshold)
    s = icp_state(target, src, R0, t0)
    align = lambda fn: lambda: fn(
        target, s["idx"], None, s["done"], s["cur"], s["R"], s["t"],
        s["last_R"], s["last_t"], s["running"])
    commit = lambda fn: lambda: fn(s["d2"], None, -1.0, s["done"], s["sse"],
                                   s["last_sse"], s["running"])

    def both(a, c, reps):
        ms = (cuda_ms(align(a), dev, reps), cuda_ms(commit(c), dev, reps))
        return None if ms[0] is None else ms[0] + ms[1]

    def iteration_ms(kernels):
        if not _cuda(dev):
            return None
        state = icp_state(target, src, R0, t0)
        t_run = time.perf_counter()
        for _ in range(ICP_ITERATIONS):
            icp_step(state, target, -1.0, kernels=kernels)
            int(state["running"].cpu()[0])
        return (time.perf_counter() - t_run) * 1e3 / ICP_ITERATIONS

    (a_flops, a_bytes), (c_flops, c_bytes) = cuda_icp.traffic(g, ns)
    bound_ms, bound_by = bound(a_flops + c_flops, a_bytes + c_bytes)
    return row("icp_align+icp_commit", f"{g}x{ns} on {nt}", out["ok"],
               out["pose_err"],
               **{k: v for k, v in out.items() if k not in ("ok",
                                                            "pose_err")},
               ms=both(cuda_icp.icp_align, cuda_icp.icp_commit, 20),
               plain_ms=both(cuda_icp.icp_align_plain,
                             cuda_icp.icp_commit_plain, 3),
               bound_ms=bound_ms, bound_by=bound_by,
               full_scan_bound_ms=bound_ms,
               device_us=device_us(lambda: (align(cuda_icp.icp_align)(),
                                            commit(cuda_icp.icp_commit)()),
                                   ("align_kernel", "commit_kernel"), dev),
               iteration_ms=iteration_ms(True),
               plain_iteration_ms=iteration_ms(False),
               threads=cuda_icp.block_threads(ns))


def pool_commit_args(g, nl, cp, n_valid, device, seed=0):
    """`pool_commit`'s arguments at a seeded mid-search pool of cp slots:
    n_valid sorted lbs in [0, 1) then INVALID, uniform group ids, centers
    and spans 2^-1..2^-5; per group best_err in [0.5, 1.5) (some entries
    dominated), 90 % active, the second half of the groups twins of the
    first; the first nl slots' bounds lb + [0, 0.3) and that + [0, 0.5);
    min_span 0.1, threshold 1e-3."""
    import torch
    from ..ops import cuda_pool
    rng = np.random.default_rng(seed)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    i64 = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)
    lbs = np.full(cp, cuda_pool.INVALID, np.float32)
    lbs[:n_valid] = np.sort(rng.uniform(0.0, 1.0, n_valid))
    best_err = rng.uniform(0.5, 1.5, g)
    s = cuda_pool.PoolState(
        lbs=f32(lbs), gids=i64(rng.integers(0, g, cp)),
        centers=f32(rng.uniform(-1, 1, (cp, 3))),
        spans=f32(0.5 ** rng.integers(1, 6, cp)), best_err=f32(best_err),
        best_ub=f32(best_err + rng.uniform(0, 0.5, g)),
        best_t=f32(rng.uniform(-1, 1, (g, 3))),
        active=torch.as_tensor(rng.uniform(size=g) < 0.9, device=device),
        steps=3, evaluated=i64(rng.integers(0, 1000, g)), dropped=i64(5),
        dropped_lb=f32(np.where(rng.uniform(size=g) < 0.2,
                                rng.uniform(0, 1, g), cuda_pool.INVALID)))
    nl = min(nl, cp)
    lb_e = f32(lbs[:nl] + rng.uniform(0, 0.3, nl))
    ub_e = lb_e + f32(rng.uniform(0, 0.5, nl))
    half = g // 2
    share = i64(np.where(np.arange(g) < half, -1, np.arange(g) - half))
    return (s, lb_e, ub_e, share, 0.1, 1e-3, cuda_pool.CommitBuffers(s, nl))


def _nn_edges(e, dev, add):
    """The NN kernels at edge shapes, bit for bit: M x T of e["nn_m"] x
    e["nn_t"]; a lattice of side e["lattice"] listed 3 times (copies a
    lattice apart, which the plan must put in different target slices),
    queried at its nodes and at midpoints (exact ties everywhere; exact
    hits must take the first copy); and queries 2e5 away (every d2 above
    BIG: (BIG, 0))."""
    import torch
    from ..ops import cuda_nn
    rng = np.random.default_rng(17)
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                    device=dev)

    def both(label, q, p):
        add(hold(cuda_nn.nn_argmin, (q, p), prefix=label))
        add(hold(cuda_nn.nn_min, (q, p), prefix=label))
        return cuda_nn.nn_argmin(q, p)

    for m in e["nn_m"]:
        for t in e["nn_t"]:
            both("", f32(rng.uniform(-1, 1, (m, 3))),
                 f32(rng.uniform(-1, 1, (t, 3))))
    side = e["lattice"]
    grid = np.mgrid[0:side, 0:side, 0:side].reshape(3, -1).T.astype(
        np.float32)
    pts, qs = f32(np.concatenate([grid] * 3)), f32(np.concatenate(
        [grid, grid + np.float32(0.5), grid + np.float32([0.5, 0, 0])]))
    d2, idx = both("duplicated lattice ", qs, pts)
    n = grid.shape[0]
    splits, chunk = nn_plan(dev, qs.shape[0], pts.shape[0])
    first = (torch.equal(idx[:n].cpu(), torch.arange(n, dtype=torch.int32))
             and int(idx.max()) < n and not bool(d2[:n].any()))
    add(row("nn_argmin", f"duplicated lattice {qs.shape[0]}x{pts.shape[0]}:"
            f" exact hits on the first copy, {splits} slices of {chunk}",
            first and splits >= 3 and chunk <= n, 0.0))
    m, t = e["far"]
    d2, idx = both("far away ", f32(rng.uniform(-1, 1, (m, 3)) - 2e5),
                   f32(rng.uniform(-1, 1, (t, 3))))
    add(row("nn_argmin", f"far away {m}x{t}: (BIG, 0)",
            bool(torch.all(d2 == cuda_nn.BIG)) and not bool(idx.any()), 0.0))


def _plain_terms(base, gids, t_lanes, proxies, gam_ub, gam_lb, gam_t_lanes,
                 slack):
    """The plain version's per-point terms (lt, ut) [nodes, ns] with unit
    weights.  With one-hot weights at point j its sums are column j bit for
    bit: every other term is +0."""
    import torch
    from ..ops import cuda_bounds
    ones = torch.ones(base.shape[1], dtype=torch.float32, device=base.device)
    parts = list(cuda_bounds._lane_terms_plain(
        base, gids, t_lanes, proxies, gam_ub, gam_lb, gam_t_lanes, slack,
        ones))
    return (torch.cat([lt for _, _, lt in parts]),
            torch.cat([ut for _, ut, _ in parts]))


def _trimmed_one_hot(terms):
    """What the trimmed lane kernel returns at n_drop 0 with one-hot weights
    at point j, from the plain version's terms (lt, ut): its bisection sees
    one term x and zeros, so lo becomes 0.5 * (lo + x) BISECT_ITERS times
    and hi stays x; ub ("under", threshold hi) is x itself and lb ("over",
    threshold lo) is x where x <= lo, else lo."""
    import torch
    from ..ops import cuda_bounds
    lt, ut = terms
    lo = torch.zeros_like(lt)
    for _ in range(cuda_bounds.BISECT_ITERS):
        lo = 0.5 * (lo + lt)
    return torch.where(lt <= lo, lt, lo), ut


def _picks(ns, n=6):
    """Point indices for one-hot checks: the first, the last and n drawn
    from their own seed (the other inputs' draws stay as they were)."""
    rng = np.random.default_rng(ns)
    return sorted({0, ns - 1, *rng.integers(0, ns, size=n).tolist()})


def _one_hot(call, terms, points):
    """Whether call(w) (lb, ub) with one-hot weights w at each source point
    j of `points` equals column j of terms (lt, ut) [nodes, ns] bit for
    bit: each node's sum is then that one term, computed with the same
    rounding, so any difference is a wrong nearest-proxy value."""
    import torch
    lt, ut = terms
    w1 = torch.zeros(lt.shape[1], dtype=torch.float32, device=lt.device)
    for j in points:
        w1.zero_()
        w1[j] = 1.0
        lb, ub = call(w1)
        if not (torch.equal(lb.reshape(-1), lt[:, j])
                and torch.equal(ub.reshape(-1), ut[:, j])):
            return False
    return True


def one_hot(fn, args, kw=None, prefix=""):
    """A bound kernel's call with one-hot point weights, bit for bit
    (`_one_hot`) against the plain version's terms (`_plain_terms`; the
    trimmed kernel at n_drop 0, `_trimmed_one_hot`): at every source point
    through the call as given, and at `_picks` through the plain version
    and through the wrapper given bare proxies and no order.  Returns the
    row."""
    import torch
    from ..ops import cuda_bounds
    a = dict(_arguments(fn, args, kw or {}))
    name, base = fn.__name__, a["base"]
    ns = base.shape[1]
    proxies, _ = cuda_bounds._search_args(name, a["proxies"],
                                          a["point_order"], ns)
    if name == "fused_bounds":
        g, b = a["t_centers"].shape[:2]
        gids = torch.arange(g, dtype=torch.int32,
                            device=base.device).repeat_interleave(b)
        t_l, gam_t = a["t_centers"].reshape(-1, 3), a["gam_t"].reshape(-1)
    else:
        gids, t_l, gam_t = a["gids"], a["t_lanes"], a["gam_t_lanes"]
    terms = _plain_terms(
        base, gids, t_l, proxies, a["gam_ub"],
        a["gam_ub"] if a["gam_lb"] is None else a["gam_lb"], gam_t,
        float(np.float32(float(a["slack"]))))
    if name == "fused_bounds_lanes_trimmed":
        terms = _trimmed_one_hot(terms)
        a["n_drop"] = 0

    def call(plain=False, **given):
        """The call as a function of its weights w, with `given` arguments
        replaced; the plain version's when plain."""
        def with_weights(w):
            b = dict(a, point_weights=w, **given)
            return _describe(fn, (), b)["plain"]() if plain else fn(**b)
        return with_weights

    bare = dict(proxies=proxies, point_order=None)
    ok = (_one_hot(call(), terms, range(ns))
          and _one_hot(call(True, **bare), terms, _picks(ns))
          and _one_hot(call(**bare), terms, _picks(ns, 2)))
    return row(name, f"{prefix}{_describe(fn, (), a)['shape']} one-hot "
               f"weights at every point", ok, 0.0)


def _bounds_edges(e, dev, add):
    """The three pruned bound kernels at edge shapes, on 8 lanes of 2
    groups and a 2 x 4 grid: at their tolerance with cluster-like weights
    (a 0/1 mask and n_drop 0.3 ns for the trimmed kernel), and bit for bit
    with one-hot weights (`_one_hot`: at every point given the proxies'
    buckets and the source order, and at `_picks` given a bare proxies
    tensor and no order; the plain version's own one-hot sums at `_picks`;
    the trimmed kernel at n_drop 0, `_trimmed_one_hot`): P x ns of
    e["bounds_p"] x e["bounds_ns"] (seeded clouds); proxies on a lattice
    with queries on its nodes and face midpoints (points on box faces and
    corners); 33 copies of one proxy split across buckets; and every d2
    above BIG."""
    import torch
    from ..ops import cuda_bounds
    rng = np.random.default_rng(19)
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                    device=dev)

    def case(label, src, proxies, t_l, rotate=True):
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
        mask = f32(rng.uniform(size=(ns,)) < 0.8)
        for fn, args, kw in (
                (cuda_bounds.fused_bounds_lanes,
                 (base, gids, t_l, buckets, gam_ub, gam_t, slack),
                 dict(point_weights=w)),
                (cuda_bounds.fused_bounds,
                 (base, tc, buckets, gam_ub, gt, slack),
                 dict(point_weights=w)),
                (cuda_bounds.fused_bounds_lanes_trimmed,
                 (base, gids, t_l, buckets, gam_ub, gam_t, slack,
                  int(round(0.3 * ns))), dict(point_weights=mask))):
            kw.update(gam_lb=gam_lb, point_order=order)
            add(hold(fn, args, kw, prefix=f"{label} "))
            add(one_hot(fn, args, kw, prefix=f"{label} "))

    for n_prox in e["bounds_p"]:
        for ns in e["bounds_ns"]:
            case(f"P{n_prox} ns{ns}",
                 rng.uniform(-0.7, 0.7, size=(ns, 3)),
                 rng.uniform(-0.9, 0.9, size=(n_prox, 3)),
                 rng.uniform(-0.4, 0.4, size=(8, 3)))
    side = e["box_lattice"]
    step = np.float32(1.0 / side)
    grid = np.mgrid[0:side, 0:side, 0:side].reshape(3, -1).T * step
    half = np.float32(step / 2)
    case("lattice nodes and faces",
         np.concatenate([grid, grid + [half, 0, 0], grid + [half, half, 0]]),
         grid, np.repeat([[0, 0, 0], [step, 0, -step]], 4, axis=0),
         rotate=False)
    n_src, n_before, n_after = e["dup"]
    dup = np.array([[0.3, 0.1, -0.2]])
    case("33 copies of one proxy",
         np.concatenate([rng.uniform(-0.7, 0.7, size=(n_src, 3)),
                         np.repeat(dup, 20, axis=0)]),
         np.concatenate([rng.uniform(-0.9, 0.9, size=(n_before, 3)),
                         np.repeat(dup, 33, axis=0),
                         rng.uniform(-0.9, 0.9, size=(n_after, 3))]),
         rng.uniform(-0.05, 0.05, size=(8, 3)))
    n_src, n_prox = e["far_bounds"]
    case("every d2 above BIG", rng.uniform(-0.7, 0.7, size=(n_src, 3)) + 2e5,
         rng.uniform(-0.9, 0.9, size=(n_prox, 3)),
         rng.uniform(-0.4, 0.4, size=(8, 3)))


def _minplus_lines(e, dev, add):
    """`minplus_1d` bit for bit on seeded lines (every third all BIG, as
    unseeded grid lines) and on constant, negative and few-valued lines."""
    import torch
    from ..ops import cuda_minplus
    from ..ops import distance_field as df
    rng = np.random.default_rng(13)
    lines_of = lambda g: torch.from_numpy(g.astype(np.float32)).to(dev)
    for lines, n in e["lines"]:
        g = rng.uniform(0.0, 4.0, size=(lines, n)).astype(np.float32)
        g[::3] = df.BIG
        add(hold(cuda_minplus.minplus_1d, (lines_of(g), 0.002),
                 prefix="every third line BIG "))
    lines, n = e["kinds"]
    for kind, g in (
            ("constant", np.repeat(rng.uniform(0.0, 4.0, size=(lines, 1)),
                                   n, axis=1)),
            ("negative", rng.uniform(-4.0, 0.5, size=(lines, n))),
            ("few-valued", rng.choice([0.0, 0.25, 1.0], size=(lines, n)))):
        add(hold(cuda_minplus.minplus_1d, (lines_of(g), 0.002),
                 prefix=f"{kind} "))


def run_check(grid: str = "full", device: str = "cuda"):
    """Every row of the grid; returns (ok, lines, rows)."""
    import torch
    from ..ops import bounds as bounds_ops
    from ..ops import coreset, cuda_bounds, cuda_fps, cuda_minplus, cuda_nn
    from ..ops import cuda_pool
    from ..ops import geometry as geo
    from .workloads import bunny_synth

    spec = GRIDS[grid]
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    rows = []
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def add(r):
        rows.append(r)
        print(f"[kernel_check] {describe(r)}", file=sys.stderr, flush=True)

    # A synthetic bunny-size scan: the target and a source pool, normalized
    # together as GoICP does; beyond the pool, scaled copies of it.
    pct, _ = bunny_synth(spec["nt"], 16)
    _, pool = bunny_synth(max(spec["pool"], 16) + 16, spec["pool"])
    norm = geo.Normalization(f32(pct), f32(pool))
    tgt, pool = norm.pct.contiguous(), norm.pcs.contiguous()
    pool3 = torch.cat([pool, pool * 0.97, pool * 1.03])
    backends = {p: bounds_ops.make_backend(tgt, kind="proxy", proxy_size=p)
                for p in set(spec["proxies"]) | {spec["grid"][3],
                                                 spec["shard_lanes"][3],
                                                 spec["anchors"][1]}}

    def groups(pts, g, deltas=None):
        xyz = f32(rng.uniform(-0.5, 0.5, size=(g, 3)))
        R = geo.quat_cube_to_matrix(xyz)
        spans = torch.full((g,), 0.125, dtype=torch.float32, device=dev)
        fix = torch.arange(g, device=dev) % 2 == 0
        base = torch.einsum("grc,nc->gnr", R, pts).contiguous()
        norms = torch.linalg.vector_norm(pts, dim=-1)
        gam_ub, gam_lb = bounds_ops.gamma_arrays(norms, spans, fix,
                                                 point_deltas=deltas)
        return base, gam_ub.contiguous(), gam_lb.contiguous()

    def lanes_of(g, n):
        gids = torch.as_tensor(rng.integers(0, g, size=(n,)), dtype=torch.int32,
                               device=dev)
        t_l = f32(rng.uniform(-0.3, 0.3, size=(n, 3)))
        gam_t = geo.translation_uncertainty_radius(
            torch.full((n,), 0.125, dtype=torch.float32, device=dev))
        return gids, t_l, gam_t.contiguous()

    def sources(k):
        """k cluster reps of the pool (weights, deltas), or the pool's first
        k points when k reaches its size."""
        if k < pool.shape[0]:
            cl = coreset.build_weighted(pool, size=k, seed=2)
            return (cl.reps.contiguous(), cl.weights.contiguous(),
                    cl.deltas.contiguous())
        return pool[:k].contiguous(), None, None

    def held(fn, args, kw, label=""):
        """A bound kernel row at its tolerance, and bit for bit with one-hot
        weights at every point (`one_hot`: at ns 30,000 the trimmed
        kernel's terms go through its scratch)."""
        add(hold(fn, args, kw, prefix=label))
        add(one_hot(fn, args, kw, prefix=label))

    def lane_row(label, psize, k, g, n_lanes):
        backend = backends[psize]
        pts, w, d = sources(k)
        base, gam_ub, gam_lb = groups(pts, g, d)
        gids, t_l, gam_t = lanes_of(g, n_lanes)
        held(cuda_bounds.fused_bounds_lanes,
             (base, gids, t_l, backend.buckets, gam_ub, gam_t,
              float(backend.coreset.eps)),
             dict(point_weights=w, gam_lb=gam_lb,
                  point_order=cuda_bounds.source_order(pts)), label)

    for psize in spec["proxies"]:
        for k in spec["ns"]:
            lane_row("", psize, k, GROUPS, LANES)

    psize = spec["proxies"][0]
    backend = backends[psize]
    slack = float(np.float32(float(backend.coreset.eps)))
    for i, (k, keep) in enumerate(spec["trimmed"]):
        pts = pool3[:k].contiguous()
        base, gam_ub, gam_lb = groups(pts, 4)
        gids, t_l, gam_t = lanes_of(4, LANES)
        args = (base, gids, t_l, backend.buckets, gam_ub, gam_t, slack,
                pts.shape[0] - keep)
        kw = dict(gam_lb=gam_lb, point_order=cuda_bounds.source_order(pts))
        held(cuda_bounds.fused_bounds_lanes_trimmed, args, kw)
        if i == 0:
            add(_unfused_row(backend, args, kw))

    def grid_row(label, g, b, k, p):
        backend = backends[p]
        pts = pool[:k].contiguous()
        base, gam_ub, gam_lb = groups(pts, g)
        t_c = f32(rng.uniform(-0.3, 0.3, size=(g, b, 3)))
        gam_t = geo.translation_uncertainty_radius(
            torch.full((g, b), 0.125, dtype=torch.float32, device=dev))
        held(cuda_bounds.fused_bounds,
             (base, t_c, backend.buckets, gam_ub, gam_t,
              float(np.float32(float(backend.coreset.eps)))),
             dict(gam_lb=gam_lb, point_order=cuda_bounds.source_order(pts)),
             label)

    grid_row("", *spec["grid"])

    def nn_rows(label, m, t, points=None, which=("nn_min", "nn_argmin")):
        q = f32(rng.uniform(-1.2, 1.2, size=(m, 3)))
        p = points if points is not None else f32(
            rng.uniform(-1.0, 1.0, size=(t, 3)))
        for name in which:
            add(hold(getattr(cuda_nn, name), (q, p), prefix=label))
            if name == "nn_argmin":
                # The winner rescored exactly reproduces its d2.
                d2, idx = cuda_nn.nn_argmin(q, p)
                w = p[idx.long()]
                dx, dy, dz = (w[:, i] - q[:, i] for i in range(3))
                d_idx = dx * dx + dy * dy + dz * dz
                add(row("argmin winner rescore", f"{label}{m}x{p.shape[0]}",
                        torch.equal(d_idx, d2),
                        float(torch.max(torch.abs(d_idx - d2)))))

    m, p = spec["anchors"]
    nn_rows("anchors ", m, p, points=backends[p].coreset.points.contiguous())
    m, t = spec["polish"]
    splits, chunk = nn_plan(dev, m, t)
    add(row("nn_argmin", f"polish {m}x{t}: {splits} slices of {chunk}",
            splits > 1, 0.0))

    for lines_n, n in spec["minplus"]:
        g = f32(rng.uniform(0.0, 0.05, size=(lines_n, n)))
        g[:, ::7] = float(np.float32(1e10))   # unseeded nodes, as the EDT's
        add(hold(cuda_minplus.minplus_1d, (g, 0.002)))

    # The device mesh's shard shapes (one rank's share of the smoke runs).
    g, n_l, k, p = spec["shard_lanes"]
    lane_row("shard ", p, k, g, n_l)
    grid_row("shard ", *spec["shard_grid"])
    nn_rows("shard ", *spec["shard_argmin"], which=("nn_argmin",))
    nn_rows("shard ", *spec["shard_min"], which=("nn_min",))

    _nn_edges(spec["edges"], dev, add)
    _bounds_edges(spec["edges"], dev, add)
    _minplus_lines(spec["edges"], dev, add)

    # FPS: its step at n = 1 sets the latency bound of every shape.
    one = tgt[:1].contiguous()
    floor_ms = cuda_ms(lambda: cuda_fps.farthest_point_sample(
        one, FPS_FLOOR_K), dev, 20)
    floor_us = None if floor_ms is None else 1e3 * floor_ms / (
        FPS_FLOOR_K - 1)
    for n, k in spec["fps"]:
        r = hold(cuda_fps.farthest_point_sample, (tgt[:n].contiguous(), k))
        r.update(layout=cuda_fps.plan_layout(n), step_floor_us=floor_us,
                 us_per_step=None if r["ms"] is None
                 else 1e3 * r["ms"] / (k - 1),
                 latency_bound_ms=None if floor_us is None
                 else floor_us * (k - 1) / 1e3,
                 issue_ms=FPS_INSTRS * n * (k - 1) / (INSTR_RATE / SMS) * 1e3)
        add(r)
    for g, ns, nt, thr in spec["icp"]:
        axes = rng.normal(size=(g, 3))
        axes /= np.linalg.norm(axes, axis=1, keepdims=True)
        turn = 0.5 * np.arange(g) / g              # radians, per lane
        R0 = geo.quat_cube_to_matrix(f32(axes * np.sin(turn / 2)[:, None]))
        t0 = f32(rng.uniform(-0.05, 0.05, size=(g, 3)))
        add(_icp_row(tgt[:nt].contiguous(), pool[:ns].contiguous(), R0, t0,
                     thr))
    for g, nl, cp, n_valid in spec["commit"]:
        args = pool_commit_args(g, nl, cp, n_valid, dev)
        r = hold(cuda_pool.pool_commit, args)
        r.update(cluster=cuda_pool.plan_cluster(cp, min(nl, cp)),
                 workspace_bytes=cuda_pool.workspace_bytes(g, min(nl, cp)),
                 device_us=device_us(
                     lambda: cuda_pool.pool_commit(*args),
                     ("pool_commit_kernel",), dev))
        add(r)
    return (all(r["ok"] for r in rows), [describe(r) for r in rows], rows)


def _unfused_row(backend, args, kw):
    """The trimmed lane kernel against the unfused path (the nearest-proxy
    search on all L x ns queries, then the torch terms and bisection
    brackets): the unfused path forms each trimmed bound as a lane total
    minus its drop sum, so its rounding shows relative to the untrimmed
    total, hence within 2e-5 + 2e-4 x the lane totals."""
    import torch
    from ..ops import bounds as bounds_ops
    from ..ops import cuda_bounds
    base, gids, t_l, buckets, gam_ub, gam_t, slack, n_drop = args
    gam_lb = kw["gam_lb"]
    g = gids.long()
    keep = base.shape[1] - n_drop

    def unfused():
        lb_pt, ub_pt = bounds_ops.point_terms(
            backend, base[g] + t_l[:, None, :], gam_ub[g], gam_lb[g], gam_t)
        return (bounds_ops.reduce_point_terms(lb_pt, None, keep,
                                              drop_mode="over"),
                bounds_ops.reduce_point_terms(ub_pt, None, keep,
                                              drop_mode="under"))

    fused = cuda_bounds.fused_bounds_lanes_trimmed(*args, **kw)
    plain = unfused()
    totals = cuda_bounds.fused_bounds_lanes(
        base, gids, t_l, buckets, gam_ub, gam_t, slack, gam_lb=gam_lb)
    err = [(k - p).abs() for k, p in zip(fused, plain)]
    ok = all(bool(torch.all(e <= 2e-5 + 2e-4 * tot.abs()))
             for e, tot in zip(err, totals))
    dev = base.device
    return row("fused_bounds_lanes_trimmed",
               f"G{base.shape[0]} L{gids.shape[0]} ns{base.shape[1]} "
               f"n_drop{n_drop} against the unfused path", ok,
               max(float(e.max()) for e in err),
               ms=cuda_ms(lambda: cuda_bounds.fused_bounds_lanes_trimmed(
                   *args, **kw), dev),
               plain_ms=cuda_ms(unfused, dev, 5))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", default="full", choices=sorted(GRIDS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    import torch
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but "
                           "torch.cuda.is_available() is False")
    t0 = time.time()
    ok, _, rows = run_check(args.grid, args.device)
    out = {"ok": ok, "grid": args.grid, "device": (
        torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
        "seconds": time.time() - t0, "rows": rows}
    text = json.dumps(out)
    print(text, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
