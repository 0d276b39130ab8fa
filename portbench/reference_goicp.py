"""The plain reference of Go-ICP's mechanism: its uncertainty radii, its
node bounds and a best-first nested branch-and-bound over SO(3) x R^3
(Yang, Li, Campbell, Jia, "Go-ICP: A Globally Optimal Solution to 3D ICP
Point-Set Registration", T-PAMI 2016), in plain torch: nothing of the
program, no TF32.

Frame: `reference.frame`'s, both clouds centred on their own means and
scaled by 1 / (the largest absolute coordinate of the centred source),
the coordinates then rounded to float32.  Distances are exact float32
differences (dx^2 + dy^2 + dz^2) to every target point, minimised per
query; sums over points are float64.

Rotations: the imaginary part x of a unit quaternion in the cube [-1, 1]^3,
w = sqrt(1 - |x|^2) (the reference implementation's parameterisation,
fast-go-icp common.hpp).  A rotation node is a cube of half-span s around
x; a translation node a cube of half-span s around t, the root [-1, 1]^3.

For a source point p and a node (rotation cube (x, s_r), translation cube
(t, s_t)), with R the rotation of x and d_i the distance of R p_i + t to
the nearest target point:

    gamma_r,i = 2 sin(min(sqrt(3) pi s_r / 2, pi / 2)) |p_i|     (eq. 6;
                0 for a fixed rotation)
    gamma_t   = sqrt(3) s_t                                      (eq. 8)
    ub = sum_i max(d_i - gamma_r,i, 0)^2
    lb = sum_i max(d_i - gamma_r,i - gamma_t, 0)^2

For a fixed rotation ub is the SSE at the node's centre; for a rotation
cube it is the relaxed objective's value there, and lb bounds every pose
of the node from below.

`search` is the nested BnB, one node at a time: one ICP from the identity
seeds the incumbent E; the outer queue pops the rotation node of lowest
lb until E - lb <= the threshold ns x mse_threshold; each child inside
SO(3) runs an inner search at its centre with the rotation fixed (the
translation that is best for that rotation; a pose below E starts an ICP,
which may lower E further), then an inner search of the relaxed objective,
whose floor is the child's lb.

Departures from the paper:
* the quaternion cube for the paper's angle-axis ball, and the radius in
  the half-angle form above, clamped at pi / 2 (the port's default, not
  the implementation's squared-norm variant);
* a child whose centre lies outside the unit ball but whose cube overlaps
  it is queued again with its parent's lb and split later (the
  implementation's rule); a child that does not overlap is dropped;
* the inner search stops when its best value is within the threshold of
  its lowest open lb, and returns as the floor the least of its best
  value, its open lbs and the lbs of nodes too small to split: a lower
  bound of the relaxed objective, where the paper returns its best value;
* nodes stop splitting at the engine's minimum spans: a rotation node
  below `rotation_min_span` is closed and its lb stays in the certificate
  gap, a translation node below `translation_min_span` floors its search;
* ICP starts from a child's fixed-rotation pose whenever that search saw
  an SSE below `trigger` times the incumbent (the implementation's rule,
  factor 1.8; the paper's is 1), from its best translation (the origin
  when it beat nothing), one start at a time: point to point,
  correspondences by exact nearest neighbour, the transform by SVD in
  float64.
"""

from __future__ import annotations

import heapq
import itertools
import math

import numpy as np
import torch

from . import reference

SQRT3 = math.sqrt(3.0)
# Elements of one [queries, targets] distance block.
BLOCK = 1 << 24


def normalized(target, source, device="cpu"):
    """(target, source) in the normalized frame, float32 tensors on
    `device`."""
    mu_t, mu_s, s = reference.frame(target, source)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return (f32((np.asarray(target, np.float64) - mu_t) * s),
            f32((np.asarray(source, np.float64) - mu_s) * s))


def nearest_d2(queries: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Squared distance [m] of each query [m, 3] to its nearest target
    point [n, 3]: exact float32 differences, by blocks of queries."""
    out = []
    step = max(1, BLOCK // max(1, target.shape[0]))
    for i in range(0, queries.shape[0], step):
        q = queries[i:i + step]
        dx = q[:, None, 0] - target[None, :, 0]
        dy = q[:, None, 1] - target[None, :, 1]
        dz = q[:, None, 2] - target[None, :, 2]
        out.append(torch.amin(dx * dx + dy * dy + dz * dz, dim=1))
    return torch.cat(out)


def nearest(queries: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Index [m] of each query's nearest target point (the first of equal
    ones)."""
    out = []
    step = max(1, BLOCK // max(1, target.shape[0]))
    for i in range(0, queries.shape[0], step):
        q = queries[i:i + step]
        d2 = ((q[:, None, 0] - target[None, :, 0]) ** 2
              + (q[:, None, 1] - target[None, :, 1]) ** 2
              + (q[:, None, 2] - target[None, :, 2]) ** 2)
        out.append(torch.argmin(d2, dim=1))
    return torch.cat(out)


def rotation(x) -> torch.Tensor:
    """The rotation [3, 3] float32 of quaternion-cube coordinates x [3]
    (computed in float64)."""
    x, y, z = (float(v) for v in x)
    ww = max(1.0 - (x * x + y * y + z * z), 0.0)
    w = math.sqrt(ww)
    return torch.tensor(
        [[ww + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)],
         [2 * (x * y + w * z), ww - x * x + y * y - z * z, 2 * (y * z - w * x)],
         [2 * (x * z - w * y), 2 * (y * z + w * x), ww - x * x - y * y + z * z]],
        dtype=torch.float64).to(torch.float32)


def rotation_radius(norms: torch.Tensor, span: float) -> torch.Tensor:
    """gamma_r per point of norm `norms`, for a rotation cube of half-span
    `span`."""
    half_angle = min(span * SQRT3 * math.pi / 2.0, math.pi / 2.0)
    return 2.0 * math.sin(half_angle) * norms


def translation_radius(span: float) -> float:
    return SQRT3 * span


def transformed(source: torch.Tensor, R: torch.Tensor, t) -> torch.Tensor:
    """R @ p + t per point, by explicit float32 products."""
    R, t = (torch.as_tensor(np.asarray(x, np.float32) if not isinstance(
        x, torch.Tensor) else x, dtype=torch.float32, device=source.device)
        for x in (R, t))
    return (source[:, 0:1] * R[:, 0] + source[:, 1:2] * R[:, 1]
            + source[:, 2:3] * R[:, 2] + t)


def sse(target, source, R, t) -> float:
    """The SSE of the pose (R, t) of the normalized clouds."""
    return float(nearest_d2(transformed(source, R, t), target)
                 .double().sum())


def distances(target, source, R, t, dist=nearest_d2) -> torch.Tensor:
    """d_i [ns] float32 at the pose; `dist` gives the squared ones."""
    d2 = dist(transformed(source, R, t), target)
    return torch.sqrt(torch.clamp(d2, min=0.0))


def node_bounds(target, source, R, rot_span, t, t_span,
                dist=nearest_d2) -> tuple:
    """(lb, ub) float of the node (rotation R with half-span rot_span, None
    for a fixed rotation; translation t with half-span t_span); `dist`
    gives the squared nearest distances."""
    d = distances(target, source, R, t, dist)
    g_r = (torch.zeros_like(d) if rot_span is None else
           rotation_radius(torch.linalg.vector_norm(source, dim=1), rot_span))
    u = torch.clamp(d - g_r, min=0.0)
    v = torch.clamp(d - g_r - translation_radius(t_span), min=0.0)
    return (float((v * v).double().sum()), float((u * u).double().sum()))


def icp(target, source, R, t, max_iter: int = 100, tol: float = 1e-5):
    """Point-to-point ICP from (R, t): (sse, R, t) of its last pose."""
    R, t = (torch.as_tensor(np.asarray(x, np.float64) if not isinstance(
        x, torch.Tensor) else x, dtype=torch.float64, device=source.device)
        for x in (R, t))
    src, tgt = source.double(), target.double()
    last = math.inf
    for _ in range(max_iter):
        cur = transformed(source, R.float(), t.float())
        err = sse(target, source, R.float(), t.float())
        if last - err <= tol * max(err, 1e-30):
            break
        last = err
        match = tgt[nearest(cur, target)]
        mu_p, mu_q = src.mean(0), match.mean(0)
        H = (src - mu_p).T @ (match - mu_q)
        U, _, Vt = torch.linalg.svd(H)
        D = torch.eye(3, dtype=torch.float64, device=source.device)
        D[2, 2] = torch.sign(torch.linalg.det(Vt.T @ U.T))
        R = Vt.T @ D @ U.T
        t = mu_q - R @ mu_p
    R, t = R.float().cpu(), t.float().cpu()
    return sse(target, source, R, t), R, t


def _children(center, span):
    half = span / 2.0
    for j in range(8):
        yield tuple(c + (half if (j >> k) & 1 else -half)
                    for k, c in enumerate(center)), half


def inner_search(target, source, R, rot_span, best: float, thr: float,
                 min_span: float):
    """Best-first BnB over translations for the rotation R (cube of
    half-span rot_span, None when fixed), pruning at `best`: (the best
    value found or `best`, its translation or None, the least ub seen, the
    floor, the nodes bounded)."""
    ties = itertools.count()
    heap = [(0.0, next(ties), (0.0, 0.0, 0.0), 1.0)]
    value, t_best, low, floor, nodes = best, None, math.inf, math.inf, 0
    while heap and value - heap[0][0] >= thr:
        _, _, t, span = heapq.heappop(heap)
        lb, ub = node_bounds(target, source, R, rot_span, t, span)
        nodes += 1
        low = min(low, ub)
        if ub < value:
            value, t_best = ub, t
        if lb >= value:
            continue
        if span < min_span:
            floor = min(floor, lb)
            continue
        for c, h in _children(t, span):
            heapq.heappush(heap, (lb, next(ties), c, h))
    open_lb = heap[0][0] if heap else math.inf
    return value, t_best, low, min(value, open_lb, floor), nodes


def _overlaps(c, span) -> bool:
    r2 = sum(v * v for v in c)
    return r2 - 2.0 * span * sum(abs(v) for v in c) + 3.0 * span * span <= 1.0


def search(target, source, mse_threshold: float,
           rotation_min_span: float = 0.05,
           translation_min_span: float = 0.1, trigger: float = 1.8,
           max_outer: int = 100000):
    """The nested BnB on world clouds: a dict of the certified optimum
    `sse` (normalized frame), its pose `R`, `t` (normalized frame), the
    `gap` it certifies (E less the least open or closed lb), `certified`
    (gap <= ns x mse_threshold) and the nodes it bounded."""
    tgt, src = normalized(target, source)
    thr = len(src) * mse_threshold
    best, R_best, t_best = icp(tgt, src, torch.eye(3), np.zeros(3))
    ties = itertools.count()
    heap = [(0.0, next(ties), (0.0, 0.0, 0.0), 1.0)]
    closed, outer, inner = math.inf, 0, 0
    while heap and best - heap[0][0] > thr and outer < max_outer:
        lb, _, c, span = heapq.heappop(heap)
        if lb >= best:
            continue
        outer += 1
        if span / 2.0 < rotation_min_span:
            closed = min(closed, lb)
            continue
        for cc, h in _children(c, span):
            if not _overlaps(cc, h):
                continue
            if sum(v * v for v in cc) > 1.0:
                heapq.heappush(heap, (lb, next(ties), cc, h))
                continue
            R = rotation(cc)
            start = best
            value, t_fix, low, _, n = inner_search(
                tgt, src, R, None, best, thr, translation_min_span)
            inner += n
            if t_fix is not None:
                best, R_best, t_best = value, R, torch.tensor(t_fix)
            if low < trigger * start:
                err, Ri, ti = icp(tgt, src, R, t_fix or (0.0, 0.0, 0.0))
                if err < best:
                    best, R_best, t_best = err, Ri, ti
            _, _, _, child_lb, n = inner_search(
                tgt, src, R, h, best, thr, translation_min_span)
            inner += n
            if child_lb < best:
                heapq.heappush(heap, (child_lb, next(ties), cc, h))
    gap = best - min(heap[0][0] if heap else math.inf, closed)
    return {"sse": best, "R": R_best.numpy(), "t": np.asarray(t_best),
            "gap": gap, "certified": gap <= thr, "outer_nodes": outer,
            "inner_nodes": inner}
