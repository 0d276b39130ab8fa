"""The pooled inner step taken apart: the counterpart of the JAX package's
scripts/step_decomp.py.

Times each piece of `ops/pool_frontier.py::bnb_r3_pooled`'s step alone, in
a loop of --iters calls, as the port's step computes it:
  sort     : the stable torch.argsort over [CP + 8L] keys and the gathers of
             its three payloads (pool_frontier.py's "sort" update);
  group_min: the per-group minimum of the CP pool keys, `_group_min`'s
             scatter_reduce (JAX: a one-hot [CP, G] min);
  incumbent: the [L, G] one-hot minimum and first arg-minimum of the
             lanes' upper bounds;
  kernel   : the lane kernel `cuda_bounds.fused_bounds_lanes`.
Beside them, `commit_ms`: everything the step does after the lane kernel
in one call of `cuda_pool.pool_commit` (one launch on the card), on
`kernel_check.pool_commit_args`'s seeded pool of CP slots, five eighths
valid; the pieces above are the plain commit's parts.
Then a full step: `bnb_r3_pooled` on micro_step's pool with every group at
a fixed rotation, by the finite difference of --iters / 2 and --iters
steps.  (With micro_step's free rotations the groups' upper bounds reach 0
within a few steps, since the rotation radius covers every point's
distance, and the pool drains: on the card at step 1 at P 1,024.  A fixed
rotation keeps ub = sum d^2 above every lower bound, whose slack holds the
covering radius, so the pool stays full.)  On the card the step comes with its
kernel launches and device time (torch.profiler), its host reads
(synchronizing calls, torch's sync debug mode) and its lane-kernel launches
(`fused_bounds_lanes.launches`), each a step.  So the gap between the
pieces and a step splits into device time and host time.

    python -m fgoicp_tpu_torch.scripts.step_decomp [--lanes 1024
        --capacity 32768 --groups 256] [--device cuda]

Prints one JSON line (ms a step for each piece).  On the card each loop is
timed by CUDA events (`timing.best_ms`, the best of 5), never by the host
clock alone; on the CPU the kernel is its plain version.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from . import micro_step, timing


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=1024)
    ap.add_argument("--capacity", type=int, default=32768)
    ap.add_argument("--groups", type=int, default=256)
    ap.add_argument("--ns", type=int, default=1024)
    ap.add_argument("--proxy", type=int, default=1024)
    ap.add_argument("--nt", type=int, default=17953)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    return ap


def sort_gather(keys, gid, cen, spn):
    """The sort update's core: a stable argsort of the keys and the gathers
    of keys and payloads by it."""
    import torch
    order = torch.argsort(keys, stable=True)
    return keys[order], gid[order], cen[order], spn[order]


def group_min(keys, gid, groups: int):
    """The pool's per-group minimum key [G] (1e30 for an empty group)."""
    from ..ops import pool_frontier
    return pool_frontier._group_min(keys, gid, groups)


def incumbent(keys, gid, groups: int):
    """The incumbent update's reductions: per group, the least lane key and
    its first lane ([G] values, [G] lanes), over the one-hot [L, G]."""
    import torch
    from ..ops.pool_frontier import BIG
    onehot = gid[:, None] == torch.arange(groups, device=gid.device)[None, :]
    return torch.min(torch.where(onehot, keys[:, None], BIG), dim=0)


def pool_arrays(rng, n, groups, device):
    """The pool's keys [n], group ids [n], centers [n, 3] and spans [n],
    drawn as the JAX script draws them."""
    import torch
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    keys = f32(rng.uniform(0, 1, (n,)))
    gid = torch.as_tensor(rng.integers(0, groups, (n,)), dtype=torch.int64,
                          device=device)
    return keys, gid, f32(rng.uniform(-1, 1, (n, 3))), f32(
        rng.uniform(0, 1, (n,)))


def run(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import torch
    from ..ops import cuda_bounds, cuda_pool
    from . import kernel_check

    dev = torch.device(args.device)
    rng = np.random.default_rng(0)
    L, CP, G, it = args.lanes, args.capacity, args.groups, args.iters
    keys, gid, cen, spn = pool_arrays(rng, CP + 8 * L, G, dev)
    problem = micro_step.lane_problem(rng, args.nt, args.ns, args.proxy, G,
                                      L, dev)

    def sort_loop():
        k, g, c, s = keys, gid, cen, spn
        for i in range(it):
            k, g, c, s = sort_gather(k, g, c, s)
            k = k + 1e-7 * i   # each pass sorts new keys, as in JAX's loop

    def min_loop():
        acc = torch.zeros(G, dtype=torch.float32, device=dev)
        for i in range(it):
            acc += group_min(keys[:CP] + 1e-7 * i, gid[:CP], G)

    def incumbent_loop():
        acc = torch.zeros(G, dtype=torch.float32, device=dev)
        for i in range(it):
            m, a = incumbent(keys[:L] + 1e-7 * i, gid[:L], G)
            acc += m + a.to(torch.float32)

    def kernel_loop():
        t = problem["kernel_args"]["t_lanes"]
        for _ in range(it):
            lb, _ = micro_step.launch_lanes(problem["kernel_args"], t)
            t = t + 1e-7 * lb[:, None]

    commit_args = kernel_check.pool_commit_args(G, L, CP, CP * 5 // 8, dev)

    def commit_loop():
        for _ in range(it):
            cuda_pool.pool_commit(*commit_args)

    commit_ms = timing.best_ms(commit_loop, dev, reps=5) / it
    pieces = {name: timing.best_ms(fn, dev, reps=5) / it for name, fn in (
        ("sort", sort_loop), ("group_min", min_loop),
        ("incumbent", incumbent_loop), ("kernel", kernel_loop))}

    full = dict(problem, fix=torch.ones_like(problem["fix"]))
    lo, hi = it // 2, it
    step, ran = micro_step.step_ms(full, lo, hi, L, CP, "sort", dev)
    n = min(ran, hi) - lo
    steps = lambda k: (lambda: micro_step.pooled(full, k, L, CP))
    counts = {}
    for k in (lo, hi):
        before = cuda_bounds.fused_bounds_lanes.launches
        _, reads = timing.synced_reads(steps(k), dev)
        launched, busy = timing.device_profile(steps(k), dev)
        counts[k] = (cuda_bounds.fused_bounds_lanes.launches - before,
                     reads, launched, busy)
    per = lambda j: (None if counts[hi][j] is None
                     else (counts[hi][j] - counts[lo][j]) / n)
    # Each count above ran the search twice (host reads, then profile).
    lane_launches = per(0) / 2
    device_ms = per(3)
    pieces_ms = sum(pieces.values())
    return {
        "tool": "step_decomp", "device": str(dev), "lanes": L,
        "capacity": CP, "groups": G, "ns": args.ns, "proxy": args.proxy,
        "iters": it, "pool_keys": CP + 8 * L,
        "pieces_ms": pieces, "pieces_sum_ms": pieces_ms,
        "commit_ms": commit_ms, "step_ms": step,
        "step_minus_pieces_ms": step - pieces_ms, "drain_step": ran,
        "step_launches": per(2), "step_host_reads": per(1),
        "step_lane_kernel_launches": lane_launches,
        "step_device_ms": device_ms,
        "step_host_ms": None if device_ms is None else step - device_ms}


def main(argv=None) -> int:
    print(json.dumps(run(argv)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
