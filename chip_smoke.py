#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`fgoicp_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each failing the run (nonzero exit) on its first failed check:
  1. print the GPU's name and power limit (nvidia-smi) and the torch / CUDA
     versions; build the CUDA kernels from `fgoicp_tpu_torch/csrc` and print
     the build seconds;
  2. compare each kernel with its plain torch version on the card at the
     main path's shapes (argmin idx equal, nn d2 rtol 1e-6, bounds
     rtol 2e-4 / atol 2e-5) and time both with CUDA events;
  3. run the default main path, `register(Config)` on cuda, on a seeded
     asymmetric 18,000 / 3,000-point pair with a known pose: it must
     certify (last_certified_gap <= sse_threshold) and recover the pose
     (R max-abs error < 5e-3, t error < 5e-3 x span); cold, then warm;
  4. the same with icp_multi_start = false, the search-only form of the
     path, which must also bound translation nodes and launch every kernel.

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


def surface_cloud(rng, n, noise=0.01):
    """Seeded asymmetric 3D Lissajous cloud (the JAX package's test
    generator, tests/test_goicp.py::_surface_cloud)."""
    s = rng.uniform(0.0, 4.5, size=(n,))
    pts = np.stack([np.cos(s), 0.7 * np.sin(2.0 * s),
                    0.4 * np.sin(3.0 * s + 0.5)], axis=1)
    pts = pts + rng.normal(scale=noise, size=(n, 3))
    return pts.astype(np.float32)


def known_transform_pair(cloud, n_target, n_source, seed=5, angle=1.8):
    """Target subsample + a source subsample moved by a known (R, t), with
    R @ source + t on the target (bench.py::_known_transform_pair)."""
    rng = np.random.default_rng(seed)
    cloud = np.asarray(cloud, np.float32)
    ti = rng.choice(len(cloud), size=n_target, replace=False)
    si = rng.choice(len(cloud), size=n_source, replace=False)
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    span = float(np.ptp(cloud, axis=0).max())
    t = np.array([0.11, -0.07, 0.05], np.float32) * span
    pcs = (cloud[si] - t) @ R
    return cloud[ti], pcs, R, t, span


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


def compare_kernels(torch, pct, pcs):
    """Phase 2: every kernel against its plain version at main-path
    shapes.  Returns the JSON rows (launch counts filled in later)."""
    from fgoicp_tpu_torch.ops import bounds as bounds_ops
    from fgoicp_tpu_torch.ops import coreset as coreset_ops
    from fgoicp_tpu_torch.ops import cuda_bounds, cuda_nn
    from fgoicp_tpu_torch.ops import geometry as geo

    dev = pct.device
    rng = np.random.default_rng(11)
    proxy = coreset_ops.build(pct, size=1024, seed=0)
    clusters = coreset_ops.build_weighted(pcs, size=1024, seed=2)
    # 16 search-ICP lanes of the 3,000-point source, as the seeding sweep.
    R16 = geo.quat_cube_to_matrix(torch.as_tensor(
        rng.uniform(-0.5, 0.5, size=(16, 3)), dtype=torch.float32, device=dev))
    t16 = torch.as_tensor(rng.uniform(-0.1, 0.1, size=(16, 1, 3)),
                          dtype=torch.float32, device=dev)
    q48k = (torch.einsum("grc,nc->gnr", R16, pcs) + t16).reshape(-1, 3).contiguous()

    def nn_case(name, kernel, plain, queries, points, reps, plain_reps):
        out_k = kernel(queries, points)
        out_p = plain(queries, points)
        torch.cuda.synchronize()
        d2_k = out_k[0] if isinstance(out_k, tuple) else out_k
        d2_p = out_p[0] if isinstance(out_p, tuple) else out_p
        if isinstance(out_k, tuple) and not torch.equal(out_k[1], out_p[1]):
            n_bad = int((out_k[1] != out_p[1]).sum())
            raise AssertionError(f"{name}: {n_bad} argmin indices differ")
        err = float((d2_k - d2_p).abs().max())
        if not torch.allclose(d2_k, d2_p, rtol=1e-6, atol=1e-9):
            raise AssertionError(f"{name}: d2 max abs err {err} beyond rtol 1e-6")
        ms = cuda_ms(torch, lambda: kernel(queries, points), reps)
        plain_ms = cuda_ms(torch, lambda: plain(queries, points), plain_reps)
        shape = f"{queries.shape[0]}x{points.shape[0]}"
        say(f"kernel {name} [{shape}]: max_abs_err {err!r}, "
            f"kernel {ms!r} ms, plain {plain_ms!r} ms")
        return dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms)

    # nn_argmin: search-ICP correspondences (16 x 3,000 against the 1,024
    # proxies) and the polish (3,000 against the 18,000-point target).
    a1 = nn_case("nn_argmin", cuda_nn.nn_argmin, cuda_nn.nn_argmin_plain,
                 q48k, proxy.points, 50, 10)
    nn_case("nn_argmin", cuda_nn.nn_argmin, cuda_nn.nn_argmin_plain,
            pcs, pct, 50, 10)
    # nn_min: the exact rescore (16 x 3,000 against 18,000) and the proxy
    # covering radius (18,000 against 1,024).
    m1 = nn_case("nn_min", cuda_nn.nn_min, cuda_nn.nn_min_plain,
                 q48k, pct, 20, 3)
    nn_case("nn_min", cuda_nn.nn_min, cuda_nn.nn_min_plain,
            pct, proxy.points, 50, 10)

    # fused_bounds_lanes: G = 256 groups (ub + lb pass of 128 children),
    # L = 1024 lanes, 1,024 cluster reps, 1,024 proxies.
    g, lanes = 256, 1024
    Rg = geo.quat_cube_to_matrix(torch.as_tensor(
        rng.uniform(-0.6, 0.6, size=(g, 3)), dtype=torch.float32, device=dev))
    reps = clusters.reps
    base = torch.einsum("grc,nc->gnr", Rg, reps).contiguous()
    spans = torch.as_tensor(rng.uniform(0.03, 0.25, size=(g,)),
                            dtype=torch.float32, device=dev)
    fix = torch.arange(g, device=dev) < g // 2
    gam_ub, gam_lb = bounds_ops.gamma_arrays(
        torch.linalg.vector_norm(reps, dim=-1), spans, fix,
        point_deltas=clusters.deltas)
    gam_ub, gam_lb = gam_ub.contiguous(), gam_lb.contiguous()
    gids = torch.as_tensor(rng.integers(0, g, size=(lanes,)),
                           dtype=torch.int32, device=dev)
    t_l = torch.as_tensor(rng.uniform(-0.5, 0.5, size=(lanes, 3)),
                          dtype=torch.float32, device=dev)
    gam_t = geo.translation_uncertainty_radius(torch.as_tensor(
        rng.uniform(0.05, 0.5, size=(lanes,)), dtype=torch.float32,
        device=dev))
    slack = float(proxy.eps)
    w = clusters.weights.contiguous()
    lb_k, ub_k = cuda_bounds.fused_bounds_lanes(
        base, gids, t_l, proxy.points, gam_ub, gam_t, slack,
        point_weights=w, gam_lb=gam_lb)
    lb_p, ub_p = cuda_bounds.fused_bounds_lanes_plain(
        base, gids, t_l, proxy.points, gam_ub, gam_lb, gam_t,
        float(np.float32(slack)), w)
    torch.cuda.synchronize()
    err = max(float((lb_k - lb_p).abs().max()), float((ub_k - ub_p).abs().max()))
    for nm, k, p in (("lb", lb_k, lb_p), ("ub", ub_k, ub_p)):
        if not torch.allclose(k, p, rtol=2e-4, atol=2e-5):
            raise AssertionError(
                f"fused_bounds_lanes {nm}: max abs err "
                f"{float((k - p).abs().max())} beyond rtol 2e-4 / atol 2e-5")
    if not bool(torch.all(lb_k <= ub_k + 1e-5)):
        raise AssertionError("fused_bounds_lanes: lb > ub on some lane")
    ms = cuda_ms(torch, lambda: cuda_bounds.fused_bounds_lanes(
        base, gids, t_l, proxy.points, gam_ub, gam_t, slack,
        point_weights=w, gam_lb=gam_lb), 50)
    plain_ms = cuda_ms(torch, lambda: cuda_bounds.fused_bounds_lanes_plain(
        base, gids, t_l, proxy.points, gam_ub, gam_lb, gam_t,
        float(np.float32(slack)), w), 5)
    shape = f"G{g} L{lanes} ns{reps.shape[0]} P{proxy.points.shape[0]}"
    say(f"kernel fused_bounds_lanes [{shape}]: max_abs_err {err!r}, "
        f"kernel {ms!r} ms, plain {plain_ms!r} ms")
    b1 = dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms)

    return [
        dict(name="nn_argmin", route="cuda", source="fgoicp_tpu_torch/csrc/nn.cu",
             replaces="fgoicp_tpu/ops/pallas_nn.py:106", **a1),
        dict(name="nn_min", route="cuda", source="fgoicp_tpu_torch/csrc/nn.cu",
             replaces="fgoicp_tpu/ops/pallas_nn.py:152", **m1),
        dict(name="fused_bounds_lanes", route="cuda",
             source="fgoicp_tpu_torch/csrc/bounds_lanes.cu",
             replaces="fgoicp_tpu/ops/pallas_bounds.py:311", **b1),
    ]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA GPU", file=sys.stderr)
        return 1

    from fgoicp_tpu_torch import Config, load_cloud, register, write_ply
    from fgoicp_tpu_torch.kernels import build
    from fgoicp_tpu_torch.ops import cuda_bounds, cuda_nn
    from fgoicp_tpu_torch.ops import geometry as geo

    # Phase 1: the card, the versions, the kernel build.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    say(smi.stdout.strip().splitlines()[0])  # name, power limit
    say(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.time()
    lib = build.load()
    say(f"kernel build: {time.time() - t0:.3f} s ({lib._name})")

    # The smoke pair: seed-0 Lissajous cloud of 24,000 points cut into an
    # 18,000-point target and a 3,000-point source moved by a known pose.
    cloud = surface_cloud(np.random.default_rng(0), 24000)
    pct_np, pcs_np, R_true, t_true, span = known_transform_pair(
        cloud, 18000, 3000)
    dev = torch.device("cuda")

    # Phase 2: kernels against their plain versions, in the normalized frame.
    norm = geo.Normalization(torch.from_numpy(pct_np).to(dev),
                             torch.from_numpy(pcs_np).to(dev))
    kernels = compare_kernels(torch, norm.pct.contiguous(),
                              norm.pcs.contiguous())

    # Phases 3 and 4: the main path through register(Config).
    WORK.mkdir(parents=True, exist_ok=True)
    tgt, src, toml = WORK / "target.ply", WORK / "source.ply", WORK / "smoke.toml"
    write_ply(str(tgt), pct_np)
    write_ply(str(src), pcs_np)
    toml.write_text(f'[io]\ntarget = "{tgt}"\nsource = "{src}"\n\n'
                    '[params]\nmse_threshold = 1e-3\n\n[engine]\nseed = 0\n')
    cfg = Config.from_toml(str(toml))
    # The reference clamps source_subsample to <= 0.5; the clouds are loaded
    # whole and handed to register so the source keeps its 3,000 points.
    pct_in, pcs_in = load_cloud(cfg.io.target), load_cloud(cfg.io.source)

    counted = (cuda_nn.nn_argmin, cuda_nn.nn_min, cuda_bounds.fused_bounds_lanes)
    for fn in counted:
        fn.launches = 0

    def drive(label, multi_start):
        cfg.engine.icp_multi_start = multi_start
        out = {}
        for run in ("cold", "warm"):
            before = {fn.__name__: fn.launches for fn in counted}
            t_run = time.time()
            model, R, t = register(cfg, pct_in, pcs_in, device="cuda")
            torch.cuda.synchronize()
            wall = time.time() - t_run
            launched = {fn.__name__: fn.launches - before[fn.__name__]
                        for fn in counted}
            R, t = np.asarray(R), np.asarray(t)
            r_err = float(np.abs(R - R_true).max())
            t_err = float(np.abs(t - t_true).max() / span)
            s = model.stats
            say(f"{label} {run}: wall {wall!r} s (register), run "
                f"{s.wall_seconds!r} s, best_sse {model.best_sse!r}, gap "
                f"{model.last_certified_gap!r} <= {model.sse_threshold!r}, "
                f"R err {r_err!r}, t err/span {t_err!r}, translation_nodes "
                f"{s.translation_nodes}, rotation_children "
                f"{s.rotation_children}, outer_steps {s.outer_steps}, "
                f"icp_runs {s.icp_runs}, launches {launched}")
            if R.shape != (3, 3) or t.shape != (3,) or not (
                    np.all(np.isfinite(R)) and np.all(np.isfinite(t))):
                raise AssertionError(f"{label}: non-finite or misshapen pose")
            if not model.last_certified_gap <= model.sse_threshold:
                raise AssertionError(f"{label}: not certified")
            if not (r_err < 5e-3 and t_err < 5e-3):
                raise AssertionError(f"{label}: pose not recovered")
            out[run] = dict(model=model, launched=launched)
        return out

    drive("default", True)
    search = drive("search-only", False)
    launches = {fn.__name__: fn.launches for fn in counted}
    for run in ("cold", "warm"):
        if search[run]["model"].stats.translation_nodes <= 0:
            raise AssertionError("search-only: no translation node bounded")
        missing = [k for k, v in search[run]["launched"].items() if v <= 0]
        if missing:
            raise AssertionError(f"search-only {run}: kernels {missing} "
                                 f"never launched on the main path")
    for row in kernels:
        row["launches"] = launches[row["name"]]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
