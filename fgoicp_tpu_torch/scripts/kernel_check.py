"""The kernel gate: every hand-written CUDA kernel of the port against its
plain torch version, on the card, over a grid of operating points.

    python -m fgoicp_tpu_torch.scripts.kernel_check [--grid full|reduced]
        [--device cuda] [--out build/kernel_check.json]

The grid is the JAX package's KERNELCHECK grid, extended:
  * `fused_bounds_lanes` at proxy P {1,024, 4,096} x ns {512, 1,024, 1,536,
    2,048, 3,037, 10,240} (source clusters of a synthetic bunny-size scan);
  * `fused_bounds_lanes_trimmed` at keep 2,126 / 3,037, 2,733 / 3,037 and
    7,168 / 10,240;
  * `fused_bounds` on a G 16 x B 32 grid at ns 3,037;
  * `nn_min` and `nn_argmin` on 8,192 anchor queries against the 4,096
    proxies, with the argmin winner rescored;
  * `minplus_1d` on seeded lines at the three pass lengths of a 0.002 field;
  * the device mesh's shard shapes: lanes at G 256, L 1,024, ns 512, P
    1,024; the grid at G 256, B 32, ns 1,500, P 1,024; `nn_argmin` 48,000 x
    9,000 and `nn_min` 24,000 x 9,000;
  * `farthest_point_sample` at the main paths' (n, k): 17,953 -> 1,024,
    3,037 -> 1,024, 8,000 -> 2,048, 6,000 -> 4,096 and 6,000 -> 1,024 (the
    first n points of the synthetic target);
  * `icp_align` + `nn_argmin` + `icp_commit` at the main paths' (lanes,
    points, target points) with their callers' convergence thresholds
    (ICP_SHAPES): 15 x 1,024 on 1,024, 1 x 3,037 on 17,953, 480 x 2,048 on
    4,096 and 32 x 8,000 on 6,000 (source lanes turned up to 0.5 rad; the
    first points of the synthetic pool and target); every iteration of
    the plain loop until its lanes stop, each step also taken on the
    kernels from the same state (`compare_icp_steps`).
Tolerances: NN, FPS indices and `minplus_1d` bit for bit (and the winner's
rescore equal to its d2); bounds rtol 2e-4 / atol 2e-5 with lb <= ub; the
ICP step's R, t, last_R, last_t and moved points within 2e-5, its SSE
within rtol 1e-4 (the kernels sum in another order than torch), last_sse
and the lanes already done bit for bit, `done` and `running` equal but
where rounding may decide the loop guard, and the guard must fire.  On
the card each row also gives the kernel's mean ms (CUDA events) and, for
the pruned bound kernels, the (point, proxy) pairs and (point, box) tests
its counters report.  `--grid reduced` keeps one point of each family,
`tiny` shrinks every shape (the CPU tests).  On the CPU the wrappers run
their plain versions, so the gate holds plain against plain.

Prints one JSON object; writes it to --out only.  Exits 0 when every row
passes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

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

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(_ROOT, "build", "kernel_check.json")

# name -> (target points, source pool points, proxies, lane ns, trimmed
# (ns, keep), grid (G, B, ns, P), NN anchors (queries, proxies), minplus
# (lines, n), shard lanes (G, L, ns, P), shard grid (G, B, ns, P), shard NN
# argmin (M, T), shard NN min (M, T), FPS (n, k) pairs, ICP (lanes, ns, nt,
# convergence threshold)).
GRIDS = {
    "full": dict(
        nt=18000, pool=20000, proxies=(1024, 4096),
        ns=(512, 1024, 1536, 2048, 3037, 10240),
        trimmed=((3037, 2126), (3037, 2733), (10240, 7168)),
        grid=(16, 32, 3037, 1024), anchors=(8192, 4096),
        minplus=((4096, 348), (4096, 584), (4096, 828)),
        shard_lanes=(256, 1024, 512, 1024), shard_grid=(256, 32, 1500, 1024),
        shard_argmin=(48000, 9000), shard_min=(24000, 9000),
        fps=((17953, 1024), (3037, 1024), (8000, 2048), (6000, 4096),
             (6000, 1024)),
        icp=ICP_SHAPES),
    "reduced": dict(
        nt=18000, pool=20000, proxies=(1024,), ns=(512, 3037),
        trimmed=((3037, 2126),), grid=(16, 32, 3037, 1024),
        anchors=(8192, 4096), minplus=((4096, 828),),
        shard_lanes=(256, 1024, 512, 1024), shard_grid=(256, 32, 1500, 1024),
        shard_argmin=(48000, 9000), shard_min=(24000, 9000),
        fps=((17953, 1024), (3037, 1024)),
        icp=(ICP_SHAPES[0], ICP_SHAPES[2])),
    "tiny": dict(
        nt=600, pool=400, proxies=(32,), ns=(48,), trimmed=((64, 45),),
        grid=(4, 4, 64, 32), anchors=(128, 32), minplus=((16, 20),),
        shard_lanes=(8, 16, 32, 32), shard_grid=(4, 4, 48, 32),
        shard_argmin=(64, 90), shard_min=(48, 90), fps=((600, 32), (90, 16)),
        icp=((3, 48, 90, 0.05),)),
}
LANES, GROUPS = 64, 6


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


def run_check(grid: str = "full", device: str = "cuda"):
    """Every row of the grid; returns (ok, lines, rows)."""
    import torch
    from ..ops import bounds as bounds_ops
    from ..ops import coreset, cuda_bounds, cuda_fps, cuda_minplus, cuda_nn
    from ..ops import geometry as geo
    from .workloads import bunny_synth

    spec = GRIDS[grid]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    rng = np.random.default_rng(0)
    rows, lines = [], []
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def ms(fn):
        if not cuda:
            return None
        fn()
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            fn()
        stop.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(stop) / 5

    def counted(launch):
        """(pairs, box tests) from a pruned kernel's counters (the card)."""
        if not cuda:
            return None
        counts = torch.zeros(2, dtype=torch.int64, device=dev)
        launch(counts)
        torch.cuda.synchronize(dev)
        return [int(v) for v in counts.cpu()]

    def add(kernel, shape, ok, err, **extra):
        rows.append(dict(kernel=kernel, shape=shape, ok=bool(ok),
                         max_abs_err=float(err), **extra))
        lines.append(f"{kernel} [{shape}]: max_abs_err {float(err)!r} "
                     f"{'OK' if ok else 'MISMATCH'}")
        print(f"[kernel_check] {lines[-1]}", file=sys.stderr, flush=True)

    def bounds_ok(got, want):
        lb_k, ub_k = got
        lb_p, ub_p = want
        err = max(float(torch.max(torch.abs(lb_k - lb_p))),
                  float(torch.max(torch.abs(ub_k - ub_p))))
        close = (torch.allclose(lb_k, lb_p, rtol=2e-4, atol=2e-5)
                 and torch.allclose(ub_k, ub_p, rtol=2e-4, atol=2e-5))
        return close and bool(torch.all(lb_k <= ub_k)), err

    # A synthetic bunny-size scan: the target and a source pool, normalized
    # together as GoICP does.
    pct, _ = bunny_synth(spec["nt"], 16)
    _, pool = bunny_synth(max(spec["pool"], 16) + 16, spec["pool"])
    norm = geo.Normalization(f32(pct), f32(pool))
    tgt, pool = norm.pct.contiguous(), norm.pcs.contiguous()
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

    def lane_row(label, psize, k, g, n_lanes):
        backend = backends[psize]
        pts, w, d = sources(k)
        base, gam_ub, gam_lb = groups(pts, g, d)
        gids, t_l, gam_t = lanes_of(g, n_lanes)
        slack = float(backend.coreset.eps)
        order = cuda_bounds.source_order(pts)
        ww = w if w is not None else torch.ones(pts.shape[0], device=dev)
        run = lambda: cuda_bounds.fused_bounds_lanes(
            base, gids, t_l, backend.buckets, gam_ub, gam_t, slack,
            point_weights=w, gam_lb=gam_lb, point_order=order)
        ok, err = bounds_ok(run(), cuda_bounds.fused_bounds_lanes_plain(
            base, gids, t_l, backend.coreset.points, gam_ub, gam_lb, gam_t,
            float(np.float32(slack)), ww))
        work = counted(lambda c: cuda_bounds._launch_lanes(
            base, gids, t_l, gam_ub, gam_lb, gam_t, ww,
            float(np.float32(slack)), backend.buckets, order, c))
        add("fused_bounds_lanes", f"{label}G{g} L{n_lanes} ns{pts.shape[0]} "
            f"P{psize}", ok, err, ms=ms(run), pairs_boxes=work,
            full_pairs=n_lanes * pts.shape[0] * psize)

    for psize in spec["proxies"]:
        for k in spec["ns"]:
            lane_row("", psize, k, GROUPS, LANES)

    psize = spec["proxies"][0]
    backend = backends[psize]
    slack = float(np.float32(float(backend.coreset.eps)))
    for k, keep in spec["trimmed"]:
        pts = pool[:k].contiguous()
        base, gam_ub, gam_lb = groups(pts, 4)
        gids, t_l, gam_t = lanes_of(4, LANES)
        order = cuda_bounds.source_order(pts)
        n_drop = pts.shape[0] - keep
        run = lambda: cuda_bounds.fused_bounds_lanes_trimmed(
            base, gids, t_l, backend.buckets, gam_ub, gam_t, slack, n_drop,
            gam_lb=gam_lb, point_order=order)
        ok, err = bounds_ok(run(), cuda_bounds.fused_bounds_lanes_trimmed_plain(
            base, gids, t_l, backend.coreset.points, gam_ub, gam_lb, gam_t,
            slack, torch.ones(pts.shape[0], device=dev), n_drop))
        add("fused_bounds_lanes_trimmed", f"L{LANES} ns{pts.shape[0]} keep "
            f"{keep} P{psize}", ok, err, ms=ms(run))

    def grid_row(label, g, b, k, p):
        backend = backends[p]
        pts = pool[:k].contiguous()
        base, gam_ub, gam_lb = groups(pts, g)
        t_c = f32(rng.uniform(-0.3, 0.3, size=(g, b, 3)))
        gam_t = geo.translation_uncertainty_radius(
            torch.full((g, b), 0.125, dtype=torch.float32, device=dev))
        order = cuda_bounds.source_order(pts)
        one = torch.ones(k, device=dev)
        sl = float(np.float32(float(backend.coreset.eps)))
        run = lambda: cuda_bounds.fused_bounds(
            base, t_c, backend.buckets, gam_ub, gam_t, sl, gam_lb=gam_lb,
            point_order=order)
        ok, err = bounds_ok(run(), cuda_bounds.fused_bounds_plain(
            base, t_c, backend.coreset.points, gam_ub, gam_lb, gam_t, sl,
            one))
        work = counted(lambda c: cuda_bounds._launch_grid(
            base, t_c, gam_ub, gam_lb, gam_t, one, sl, backend.buckets,
            order, c))
        add("fused_bounds", f"{label}G{g} B{b} ns{k} P{p}", ok, err,
            ms=ms(run), pairs_boxes=work, full_pairs=g * b * k * p)

    grid_row("", *spec["grid"])

    def nn_rows(label, m, t, points=None, which=("nn_min", "nn_argmin")):
        q = f32(rng.uniform(-1.2, 1.2, size=(m, 3)))
        p = points if points is not None else f32(
            rng.uniform(-1.0, 1.0, size=(t, 3)))
        for name in which:
            fn = getattr(cuda_nn, name)
            got, want = fn(q, p), getattr(cuda_nn, name + "_plain")(q, p)
            same = (all(torch.equal(a, b) for a, b in zip(got, want))
                    if name == "nn_argmin" else torch.equal(got, want))
            d_got = got[0] if name == "nn_argmin" else got
            d_want = want[0] if name == "nn_argmin" else want
            err = float(torch.max(torch.abs(d_got - d_want)))
            add(name, f"{label}{m}x{p.shape[0]}", same, err,
                ms=ms(lambda: fn(q, p)))
            if name == "nn_argmin":
                # The winner rescored exactly reproduces its d2.
                w = p[got[1].long()]
                dx, dy, dz = (w[:, i] - q[:, i] for i in range(3))
                d_idx = dx * dx + dy * dy + dz * dz
                add("argmin winner rescore", f"{label}{m}x{p.shape[0]}",
                    torch.equal(d_idx, got[0]),
                    float(torch.max(torch.abs(d_idx - got[0]))))

    m, p = spec["anchors"]
    nn_rows("anchors ", m, p, points=backends[p].coreset.points.contiguous())

    for lines_n, n in spec["minplus"]:
        g = f32(rng.uniform(0.0, 0.05, size=(lines_n, n)))
        g[:, ::7] = float(np.float32(1e10))   # unseeded nodes, as the EDT's
        got = cuda_minplus.minplus_1d(g, 0.002)
        want = cuda_minplus.minplus_1d_plain(g, 0.002)
        add("minplus_1d", f"{lines_n}x{n}", torch.equal(got, want),
            float(torch.max(torch.abs(got - want))),
            ms=ms(lambda: cuda_minplus.minplus_1d(g, 0.002)))

    # The device mesh's shard shapes (one rank's share of the smoke runs).
    g, n_l, k, p = spec["shard_lanes"]
    lane_row("shard ", p, k, g, n_l)
    grid_row("shard ", *spec["shard_grid"])
    nn_rows("shard ", *spec["shard_argmin"], which=("nn_argmin",))
    nn_rows("shard ", *spec["shard_min"], which=("nn_min",))

    for n, k in spec["fps"]:
        p = tgt[:n].contiguous()
        got = cuda_fps.farthest_point_sample(p, k)
        want = cuda_fps.farthest_point_sample_plain(p, k)
        add("farthest_point_sample", f"{p.shape[0]}->{k}",
            torch.equal(got, want), float(torch.max(torch.abs(got - want))),
            ms=ms(lambda: cuda_fps.farthest_point_sample(p, k)))
    for g, ns, nt, thr in spec["icp"]:
        target = tgt[:nt].contiguous()
        axes = rng.normal(size=(g, 3))
        axes /= np.linalg.norm(axes, axis=1, keepdims=True)
        turn = 0.5 * np.arange(g) / g              # radians, per lane
        R0 = geo.quat_cube_to_matrix(f32(axes * np.sin(turn / 2)[:, None]))
        t0 = f32(rng.uniform(-0.05, 0.05, size=(g, 3)))
        src = pool[:ns].contiguous()
        out = compare_icp_steps(target, src, R0, t0, thr)
        s = icp_state(target, src, R0, t0)
        add("icp_align+icp_commit", f"{g}x{ns} on {nt}", out["ok"],
            out["pose_err"], **{k: v for k, v in out.items()
                                if k not in ("ok", "pose_err")},
            ms=ms(lambda: icp_step(s, target, -1.0)))
    return all(r["ok"] for r in rows), lines, rows


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
