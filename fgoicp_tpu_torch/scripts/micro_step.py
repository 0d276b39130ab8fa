"""The pooled inner step against its bare lane kernel: the counterpart of
the JAX package's scripts/micro_step.py.

Times (a) the lane kernel `cuda_bounds.fused_bounds_lanes` alone, L lanes a
call, and (b) full `ops/pool_frontier.py::bnb_r3_pooled` steps on an
always-full synthetic pool (an incumbent of 1e12, min_span 0 and
sse_threshold -1: nothing is pruned), each by the finite difference of
--steps and 2 x --steps calls or steps, so set-up cancels.  The gap between
the two is the scheduler's cost a step (sort or merge, gathers, one-hots,
the host read of the loop's condition).

The pool still drains: spans halve every generation, groups converge
exactly (lb == ub == best_err), every child is dominated and emptied groups
deactivate.  The difference must stay below the drain step, so the tool
refuses when the pool drains at or before --steps and warns when it drains
before 2 x --steps.

    python -m fgoicp_tpu_torch.scripts.micro_step [--lanes 1024 --ns 1024
        --proxy 4096] [--pool-update sort|merge] [--device cuda]

Prints one JSON line.  On the card the times are CUDA events around each
timed call (`timing.best_ms`, the best of 3); on the CPU the kernel is its
plain version and the host clock times it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from . import timing


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=1024)
    ap.add_argument("--ns", type=int, default=1024)
    ap.add_argument("--nt", type=int, default=17953)
    ap.add_argument("--proxy", type=int, default=4096)
    ap.add_argument("--groups", type=int, default=256)
    ap.add_argument("--capacity", type=int, default=32768)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--pool-update", default="sort",
                    choices=("sort", "merge"))
    ap.add_argument("--device", default="cuda")
    return ap


def lane_problem(rng, nt, ns, proxy, groups, lanes, device):
    """The synthetic search both tools run, drawn from `rng` in the JAX
    scripts' order: a uniform target [nt, 3] in +-0.9 and its proxy
    backend, a uniform source [ns, 3] in +-0.7, `groups` rotations from
    cube centers in +-0.5 (span 0.25, none fixed); and the lane kernel's
    arguments for `lanes` lanes (random groups, translations in +-0.5,
    translation span 0.25)."""
    import torch
    from ..ops import bounds as bounds_ops
    from ..ops import cuda_bounds
    from ..ops import geometry as geo

    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    pct = f32(rng.uniform(-0.9, 0.9, (nt, 3)))
    pcs = f32(rng.uniform(-0.7, 0.7, (ns, 3)))
    backend = bounds_ops.make_backend(pct, kind="proxy", proxy_size=proxy)
    R = geo.quat_cube_to_matrix(f32(rng.uniform(-0.5, 0.5, (groups, 3))))
    spans = torch.full((groups,), 0.25, dtype=torch.float32, device=device)
    fix = torch.zeros(groups, dtype=torch.bool, device=device)
    base = torch.einsum("grc,nc->gnr", R, pcs).contiguous()
    gam_ub, gam_lb = bounds_ops.gamma_arrays(
        torch.linalg.vector_norm(pcs, dim=-1), spans, fix)
    gids = torch.as_tensor(rng.integers(0, groups, (lanes,)),
                           dtype=torch.int32, device=device)
    t_lanes = f32(rng.uniform(-0.5, 0.5, (lanes, 3)))
    gam_t = geo.translation_uncertainty_radius(
        torch.full((lanes,), 0.25, dtype=torch.float32, device=device))
    order = cuda_bounds.source_order(pcs)
    kernel_args = dict(
        base=base, gids=gids, t_lanes=t_lanes, proxies=backend.buckets,
        gam_ub=gam_ub.contiguous(), gam_t_lanes=gam_t.contiguous(),
        slack=float(backend.coreset.eps), gam_lb=gam_lb.contiguous(),
        point_order=order)
    return dict(backend=backend, pcs=pcs, R=R, spans=spans, fix=fix,
                order=order, kernel_args=kernel_args)


def launch_lanes(kernel_args, t_lanes=None):
    """One lane-kernel call on the problem's arguments (lb, ub [L])."""
    from ..ops import cuda_bounds
    a = dict(kernel_args)
    if t_lanes is not None:
        a["t_lanes"] = t_lanes
    return cuda_bounds.fused_bounds_lanes(
        a["base"], a["gids"], a["t_lanes"], a["proxies"], a["gam_ub"],
        a["gam_t_lanes"], a["slack"], gam_lb=a["gam_lb"],
        point_order=a["point_order"])


def pooled(problem, max_steps, lanes, capacity, pool_update="sort"):
    """bnb_r3_pooled on the always-full pool, `max_steps` steps at most."""
    from ..ops import pool_frontier
    p = problem
    return pool_frontier.bnb_r3_pooled(
        p["backend"], p["pcs"], p["R"], p["spans"], p["fix"], 1e12, -1.0,
        min_span=0.0, lanes=lanes, capacity=capacity, max_steps=max_steps,
        pool_update=pool_update, point_order=p["order"])


def drain_guard(ran: int, lo: int, hi: int) -> None:
    """The JAX script's refusal (the pool drains at or before lo) and
    warning (before hi)."""
    if ran <= lo:
        raise SystemExit(
            f"pool drains at step {ran} <= --steps {lo}: the finite "
            f"difference would measure nothing — pass --steps <= "
            f"{max(1, ran // 2)}")
    if ran < hi:
        print(f"WARNING: pool drains at step {ran} < {hi}; pass "
              f"--steps <= {max(1, ran // 2)} for a clean difference",
              file=sys.stderr)


def step_ms(problem, lo, hi, lanes, capacity, pool_update, device):
    """(ms a pooled step by the finite difference of lo and hi steps, the
    step the pool drains at)."""
    ran = pooled(problem, hi, lanes, capacity, pool_update).steps
    drain_guard(ran, lo, hi)
    w = timing.best_ms(lambda: pooled(problem, lo, lanes, capacity,
                                      pool_update), device)
    w2 = timing.best_ms(lambda: pooled(problem, hi, lanes, capacity,
                                       pool_update), device)
    return (w2 - w) / (min(ran, hi) - lo), ran


def run(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import torch
    dev = torch.device(args.device)
    problem = lane_problem(np.random.default_rng(0), args.nt, args.ns,
                           args.proxy, args.groups, args.lanes, dev)

    def kernel_loop(n):
        for _ in range(n):
            launch_lanes(problem["kernel_args"])

    n = args.steps
    w = timing.best_ms(lambda: kernel_loop(n), dev)
    w2 = timing.best_ms(lambda: kernel_loop(2 * n), dev)
    per_kernel = (w2 - w) / n
    per_step, ran = step_ms(problem, n, 2 * n, args.lanes, args.capacity,
                            args.pool_update, dev)
    return {
        "tool": "micro_step", "device": str(dev), "lanes": args.lanes,
        "ns": args.ns, "nt": args.nt, "proxy": args.proxy,
        "groups": args.groups, "capacity": args.capacity,
        "steps": args.steps, "pool_update": args.pool_update,
        "drain_step": ran, "kernel_ms_per_step": per_kernel,
        "kernel_us_per_lane": 1e3 * per_kernel / args.lanes,
        "pooled_ms_per_step": per_step,
        "scheduler_ms_per_step": per_step - per_kernel}


def main(argv=None) -> int:
    print(json.dumps(run(argv)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
