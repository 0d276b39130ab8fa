"""The program's search nodes against the plain reference of Go-ICP's
mechanism (`reference_goicp.py`).

    python3 -m portbench.compare_goicp --workload bunny_goicp.fixed_poses \
        [--nodes 1000] [--seed 0] [--out FILE]

Takes the first pair of the cell's set (a `pair_set` mix, in the order
the set was drawn) and records nodes of the pooled inner BnB, two ways:

* `request`: the pair through the cell's entry, the nodes of the search's
  first pooled steps, at least --nodes of them;
* `fine`: one inner-BnB call of the pair's engine over eight rotation
  cubes of the finest level the outer loop splits (`fine_cubes`: half-span
  the engine's rotation_min_span rounded up to a power of 2, one around
  the known rotation, the others beside it and across SO(3)), under an
  incumbent no node beats, so that the relaxed groups search too (in a
  request their coarse cubes mostly bound 0 and stop at the root).

A node is each lane the proxy lane kernel (`fused_bounds_lanes`) bounds,
with its rotation cube (the child handed to `GoICP._evaluate_children`,
fixed in the ub pass), its translation cube and the lb and ub the program
returned; empty pool slots (a translation span of 0) and the padding
groups of a short outer batch are left out.  Each node is held against
the plain reference, computed on the same device:

* `lb_excess`: the program's lb over the plain exact lb (nearest distances
  to every target point, every source point): the proxy bound is looser,
  never tighter;
* `sample_excess`: the program's lb over the least SSE of `SAMPLES` poses
  drawn inside the node (rotation cube x translation cube; the centre
  rotation in the ub pass);
* `ub_deficit`: the plain node ub at the node's centre (the SSE there in
  the ub pass, the relaxed objective in the lb pass) over the program's
  ub.

Each is max over nodes of (difference) / (RTOL x reference + ATOL), the
bound kernels' own tolerance (their sums run in another order than the
plain versions'), so a node passes with a value <= 1 and fails above.
The control puts bounds from TF32 distances (`reference.round_tf32`: the
norm expansion on TF32 operands) in the program's place; it has to fail.
One JSON line with both.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys

import numpy as np
import torch

from portbench import reference, reference_goicp as rg, spec

RTOL, ATOL = 2e-4, 2e-5
SAMPLES = 8


@contextlib.contextmanager
def capture(limit: int):
    """Records the pooled lanes of GoICP searches run inside it into the
    yielded list, as dicts (rot_center, rot_span, fixed, t, t_span, lb,
    ub), whole steps until `limit` nodes."""
    from fgoicp_tpu_torch.models.goicp import GoICP
    from fgoicp_tpu_torch.ops import cuda_bounds
    nodes, batch = [], {}
    evaluate, lanes = GoICP._evaluate_children, cuda_bounds.fused_bounds_lanes

    def evaluate_children(self, children):
        batch.update(children=list(children), groups=self.n_groups)
        return evaluate(self, children)

    def fused_bounds_lanes(base, gids, t_lanes, proxies, gam_ub, gam_t_lanes,
                           slack, *args, **kw):
        lb, ub = lanes(base, gids, t_lanes, proxies, gam_ub, gam_t_lanes,
                       slack, *args, **kw)
        if len(nodes) < limit and batch:
            g, children = batch["groups"], batch["children"]
            rows = zip(*(x.cpu().tolist() for x in (gids, t_lanes,
                                                    gam_t_lanes, lb, ub)))
            for k, t, gam_t, lo, hi in rows:
                if gam_t > 0.0 and k % g < len(children):
                    x, y, z, span = children[k % g]
                    nodes.append(dict(rot_center=(x, y, z), rot_span=span,
                                      fixed=k < g, t=tuple(t),
                                      t_span=gam_t / rg.SQRT3, lb=lo, ub=hi))
        return lb, ub

    # The wrapper counts its launches through its module-level name, so the
    # stand-in carries the counter while installed and hands it back.
    fused_bounds_lanes.launches = lanes.launches
    GoICP._evaluate_children = evaluate_children
    cuda_bounds.fused_bounds_lanes = fused_bounds_lanes
    try:
        yield nodes
    finally:
        GoICP._evaluate_children = evaluate
        cuda_bounds.fused_bounds_lanes = lanes
        lanes.launches = fused_bounds_lanes.launches


def nearest_d2_tf32(queries, target):
    """The control's squared nearest distances: the norm expansion
    |q|^2 + |p|^2 - 2 q.p with the cross term on TF32 operands."""
    tn = torch.sum(target * target, dim=1)
    tr = reference.round_tf32(target)
    out = []
    step = max(1, rg.BLOCK // max(1, target.shape[0]))
    for i in range(0, queries.shape[0], step):
        q = queries[i:i + step]
        d2 = (torch.sum(q * q, dim=1)[:, None] + tn[None, :]
              - 2.0 * (reference.round_tf32(q) @ tr.T))
        out.append(torch.clamp(torch.amin(d2, dim=1), min=0.0))
    return torch.cat(out)


def _sample_pose(rng, node):
    """A pose (R, t) drawn uniformly inside the node (cube coordinates
    inside the unit ball)."""
    c, h = np.asarray(node["rot_center"]), node["rot_span"]
    while True:
        x = c if node["fixed"] else c + rng.uniform(-h, h, 3)
        if np.dot(x, x) <= 1.0:
            break
    s = node["t_span"]
    return rg.rotation(x), np.asarray(node["t"]) + rng.uniform(-s, s, 3)


def _excess(value, ref):
    return (value - ref) / (RTOL * abs(ref) + ATOL)


def reference_bounds(nodes, target, source, seed: int = 0):
    """Per node (exact lb, exact ub at the centre, least sampled SSE) on
    the normalized clouds."""
    rng = np.random.default_rng(seed)
    out = []
    for n in nodes:
        R = rg.rotation(n["rot_center"])
        rot = None if n["fixed"] else n["rot_span"]
        lb, ub = rg.node_bounds(target, source, R, rot, n["t"], n["t_span"])
        low = min(rg.sse(target, source, *_sample_pose(rng, n))
                  for _ in range(SAMPLES))
        out.append((lb, ub, low))
    return out


def judge(bounds, refs) -> dict:
    """The three readings of program bounds [(lb, ub)] against the
    reference's, each the worst over the nodes (pass: <= 1)."""
    worst = lambda xs: max(xs) if xs else None
    return {
        "lb_excess": worst([_excess(lb, r[0]) for (lb, _), r
                            in zip(bounds, refs)]),
        "sample_excess": worst([_excess(lb, r[2]) for (lb, _), r
                                in zip(bounds, refs)]),
        "ub_deficit": worst([-_excess(ub, r[1]) for (_, ub), r
                             in zip(bounds, refs)]),
    }


def tf32_bounds(nodes, target, source):
    """The control: each node's (lb, ub) from TF32 distances."""
    return [rg.node_bounds(target, source, rg.rotation(n["rot_center"]),
                           None if n["fixed"] else n["rot_span"], n["t"],
                           n["t_span"], dist=nearest_d2_tf32)
            for n in nodes]


def cube_coords(R) -> np.ndarray:
    """The quaternion-cube coordinates of the rotation R (w >= 0)."""
    R = np.asarray(R, np.float64)
    w = math.sqrt(max(1.0 + np.trace(R), 1e-12)) / 2.0
    return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                     R[1, 0] - R[0, 1]]) / (4.0 * w)


def fine_cubes(R, min_span: float) -> list:
    """Eight rotation cubes (x, y, z, half-span) of the finest level the
    outer loop splits: one around R's coordinates, three beside it, four
    across SO(3); centres pulled inside the unit ball."""
    h = 2.0 ** math.ceil(math.log2(min_span))
    c = cube_coords(R)
    centres = [c, c + (2 * h, 0, 0), c + (0, 2 * h, 0), c + (0, 0, 2 * h),
               (0.3, -0.2, 0.1), (-0.5, 0.4, 0.2), (0.1, 0.6, -0.3),
               (-0.2, -0.3, -0.7)]
    out = []
    for x in centres:
        x = np.asarray(x, np.float64)
        x = x * min(1.0, (1.0 - h) / max(np.linalg.norm(x), 1e-12))
        out.append(tuple(float(v) for v in x) + (h,))
    return out


def fine_nodes(model, R, limit: int) -> list:
    """The nodes of one inner-BnB call of `model` (a GoICP) over
    `fine_cubes` around R, with no incumbent to prune by."""
    model.best_sse = 1e9
    with capture(limit) as nodes:
        model._evaluate_children(
            fine_cubes(R, model.engine.rotation_min_span))
    return nodes


def verdict(nodes, target, source, seed: int = 0) -> dict:
    """The nodes' readings and the control's on the normalized clouds."""
    refs = reference_bounds(nodes, target, source, seed)
    program = judge([(n["lb"], n["ub"]) for n in nodes], refs)
    control = judge(tf32_bounds(nodes, target, source), refs)
    ok = lambda r: all(v is not None and v <= 1.0 for v in r.values())
    return {"nodes": len(nodes), "fixed": sum(n["fixed"] for n in nodes),
            "relaxed_lb_max": max((r[0] for n, r in zip(nodes, refs)
                                   if not n["fixed"]), default=0.0),
            "program": program, "passed": ok(program), "control": control,
            "control_passed": ok(control)}


def compare(config: dict, pair, device, limit: int, seed: int = 0) -> dict:
    """Both ways of taking nodes (module doc) for `pair`, judged."""
    from fgoicp_tpu_torch.config import EngineConfig
    from fgoicp_tpu_torch.models.goicp import GoICP
    entry = spec.entry(config["entry"])
    state = entry.build(config, None, device)
    with capture(limit) as nodes:
        answer = entry.call(state, pair)[0]
    target, source = rg.normalized(pair.target, pair.sources[0], device)
    model = GoICP(pair.target, pair.sources[0],
                  mse_threshold=float(config["mse_threshold"]),
                  engine=EngineConfig(**config.get("engine", {})),
                  device=device)
    fine = fine_nodes(model, pair.truths[0][0], limit)
    return {"certified": answer.certified,
            "request": verdict(nodes, target, source, seed),
            "fine": verdict(fine, target, source, seed)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--nodes", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cell = spec.cell(spec.benchmark(), args.workload)
    config, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    pair = spec.module("kinds", mix["kind"]).pairs(config, mix)[1]
    line = {"workload": args.workload,
            "device": torch.cuda.get_device_name(),
            **compare(config, pair, "cuda", args.nodes, args.seed)}
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    good = all(line[k]["passed"] and not line[k]["control_passed"]
               for k in ("request", "fine"))
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
