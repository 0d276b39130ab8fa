"""A/B: the min-plus kernel against its plain version, alone and in the EDT
field build: the counterpart of the JAX package's
scripts/minplus_experiment.py.

The exact EDT distance-field builder (`ops/distance_field.py::_build_edt`)
spends its time in the 1-D parabolic min-plus transform, three passes of
`cuda_minplus.minplus_1d`.  Three steps:
  1. the kernel against a float64 reference on seeded lines [2,048 x
     1,000] at resolution 0.002: the max error must stay below 1e-4;
  2. the kernel against `minplus_1d_plain` at the block-aligned [262,144 x
     1,024]: ms (the best of 3, CUDA events) and Top/s at 2 L n^2
     operations, and the two outputs compared bit for bit;
  3. the EDT field build at 0.002, cold then steady, through the kernel
     and through the plain version (the script rebinds
     `cuda_minplus.minplus_1d` to the plain version for that build and
     restores it after), with the two fields compared.  With --data the
     target is the reference's bunny (data/bunny/model_bunny.txt at
     subsample 0.5, normalized with data_bunny.txt at 0.1); without it the
     target of `workloads.bunny_synth`.

    python -m fgoicp_tpu_torch.scripts.minplus_experiment [--data DIR]
        [--device cuda]

Prints one JSON line; exits nonzero when step 1's error reaches 1e-4 or
step 2's outputs differ.  On the CPU the kernel is its plain version.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from . import timing

TOLERANCE = 1e-4


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", type=int, nargs=2, default=(2048, 1000),
                    metavar=("L", "N"), help="step 1's lines and length")
    ap.add_argument("--big", type=int, nargs=2, default=(262144, 1024),
                    metavar=("L", "N"), help="step 2's lines and length")
    ap.add_argument("--resolution", type=float, default=0.002)
    ap.add_argument("--data", default="",
                    help="the reference's data/ directory (the bunny)")
    ap.add_argument("--device", default="cuda")
    return ap


def f64_reference(g, res: float):
    """min_j g[l, j] + ((i - j) res)^2 in float64, [L, n], in chunks of
    lines on g's device."""
    import torch
    lines, n = g.shape
    j = torch.arange(n, dtype=torch.float64, device=g.device)
    cost = ((j[None, :] - j[:, None]) * res) ** 2          # [j, i]
    g64 = g.to(torch.float64)
    out = torch.empty((lines, n), dtype=torch.float64, device=g.device)
    chunk = max(1, 2 ** 26 // (n * n))
    for l0 in range(0, lines, chunk):
        out[l0:l0 + chunk] = torch.amin(g64[l0:l0 + chunk, :, None]
                                        + cost[None], dim=1)
    return out


def field_target(data: str):
    """(normalized target [N, 3] as numpy, its bounds [3, 2]) of step 3."""
    import torch
    from ..ops import geometry as geo
    from . import workloads
    if data:
        from ..io import load_cloud
        pct = load_cloud(f"{data}/bunny/model_bunny.txt", 0.5, seed=0)
        pcs = load_cloud(f"{data}/bunny/data_bunny.txt", 0.1, seed=1)
    else:
        pct, pcs = workloads.bunny_synth()
    norm = geo.Normalization(torch.from_numpy(np.asarray(pct, np.float32)),
                             torch.from_numpy(np.asarray(pcs, np.float32)))
    return norm.pct.numpy(), norm.target_bounds.numpy()


def builds(points, bounds, res, device):
    """(cold s, steady s, field values) of two EDT builds."""
    import torch
    from ..ops import distance_field as df
    walls = []
    for _ in range(2):
        timing.synchronize(device)
        t0 = time.perf_counter()
        f = df.build(torch.as_tensor(points, device=device), bounds, res,
                     builder="edt")
        timing.synchronize(device)
        walls.append(time.perf_counter() - t0)
    return walls[0], walls[1], f.values


def run(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.data and not os.path.isdir(args.data):
        raise SystemExit(f"--data {args.data}: not a directory (the "
                         f"reference's data/ directory holds the bunny)")
    import torch
    from ..ops import cuda_minplus

    dev = torch.device(args.device)
    rng = np.random.default_rng(0)
    res = args.resolution
    out = {"tool": "minplus_experiment", "device": str(dev),
           "resolution": res}

    # 1. Against float64.
    g_small = torch.as_tensor(rng.uniform(0, 4.0, tuple(args.small)).astype(
        np.float32), device=dev)
    got = cuda_minplus.minplus_1d(g_small, res)
    err = float(torch.max(torch.abs(got.to(torch.float64)
                                    - f64_reference(g_small, res))))
    out["f64_check"] = dict(shape=list(args.small), max_err=err,
                            ok=err < TOLERANCE)
    del g_small, got

    # 2. Kernel against plain at a block-aligned shape.
    L, n = args.big
    g = torch.as_tensor(rng.uniform(0, 4.0, (L, n)).astype(np.float32),
                        device=dev)
    ops = 2.0 * L * n * n
    k_ms = timing.best_ms(lambda: cuda_minplus.minplus_1d(g, res), dev)
    p_ms = timing.best_ms(lambda: cuda_minplus.minplus_1d_plain(g, res), dev)
    equal = bool(torch.equal(cuda_minplus.minplus_1d(g, res),
                             cuda_minplus.minplus_1d_plain(g, res)))
    out["aligned"] = dict(shape=[L, n], kernel_ms=k_ms, plain_ms=p_ms,
                          kernel_tops=ops / k_ms / 1e9,
                          plain_tops=ops / p_ms / 1e9, bits_equal=equal)
    del g

    # 3. The EDT field build, kernel then plain.
    points, bounds = field_target(args.data)
    k_cold, k_steady, k_field = builds(points, bounds, res, dev)
    real = cuda_minplus.minplus_1d
    cuda_minplus.minplus_1d = cuda_minplus.minplus_1d_plain
    try:
        p_cold, p_steady, p_field = builds(points, bounds, res, dev)
    finally:
        cuda_minplus.minplus_1d = real
    out["field_build"] = dict(
        target="bunny" if args.data else "bunny_synth",
        dims=list(k_field.shape), kernel_cold_s=k_cold,
        kernel_steady_s=k_steady, plain_cold_s=p_cold,
        plain_steady_s=p_steady,
        fields_equal=bool(torch.equal(k_field, p_field)))
    return out


def main(argv=None) -> int:
    out = run(argv)
    print(json.dumps(out), flush=True)
    if not out["f64_check"]["ok"]:
        print(f"minplus_1d: max error {out['f64_check']['max_err']!r} "
              f"against float64, not below {TOLERANCE}", file=sys.stderr)
        return 1
    if not out["aligned"]["bits_equal"]:
        print("minplus_1d: the kernel's output differs from the plain "
              "version's", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
