"""The pooled inner BnB's step bookkeeping: the CUDA kernel `pool_commit`
(`csrc/pool_step.cu`) and its plain torch version.

No TPU kernel: the JAX package's pooled step
(`fgoicp_tpu/ops/pool_frontier.py::bnb_r3_pooled`) is XLA ops in a
`lax.while_loop`.  A step of `ops/pool_frontier.py::bnb_r3_pooled` is the
lane evaluation, then a commit: lane validity, the per-group incumbents,
the twin share, the octree split, the pool update, the counters and the
groups' convergence.  `pool_commit_plain` is those torch ops, for both pool
updates ("sort": filter, stable-sort, truncate; "merge": `_merge_sorted`)
and with the mesh's twin-share all-gather; `pool_commit` is the "sort"
update in one launch, bit for bit.

Dispatch: tensors on the CPU go to the plain version; CUDA tensors launch
the kernel or raise — there is no fallback from the card to the plain
version.  `pool_commit.launches` counts the kernel launches (the plain
version does not count; a request reads it through
`utils/trace.py::LAUNCH_COUNTERS`).

Both write what the next step needs besides the state into a
`CommitBuffers`: the first lanes' group ids as int32 and their gam_t (the
lane kernels' inputs) and the live flag (any group active), the one value
the host reads a step.  On the card the kernel writes the new state into
the one of the buffers' two states that the old state is not, so a step
never sorts in place; the cluster size and where the kernel keeps its
workspace follow from the shapes alone (`plan_cluster`, `SMEM_LIMIT`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels import build
from ..parallel.sharding import sharded
from ..utils import debug
from . import geometry as geo

INVALID = 1e30
BIG = 1e10

# The most blocks a cluster takes (csrc/pool_step.cu: 1,024 threads each),
# and the old pool entries a block should place at least: a cluster of
# ceil((CP - L) / ENTRIES_PER_BLOCK) blocks, 1 to MAX_CLUSTER.
MAX_CLUSTER = 8
ENTRIES_PER_BLOCK = 4096
# The dynamic shared memory a block may take for its workspace: an H100's
# opt-in 232,448 bytes a block, less room for the kernel's static buffers.
SMEM_LIMIT = 232_448 - 1024


class PoolState(NamedTuple):
    lbs: torch.Tensor        # [CP] (INVALID marks empty slots)
    gids: torch.Tensor       # [CP] int64
    centers: torch.Tensor    # [CP, 3]
    spans: torch.Tensor      # [CP]
    best_err: torch.Tensor   # [G] per-group pruning incumbent
    best_ub: torch.Tensor    # [G] min upper bound seen
    best_t: torch.Tensor     # [G, 3]
    active: torch.Tensor     # [G] bool
    steps: int               # host loop counter
    evaluated: torch.Tensor  # [G] int64
    dropped: torch.Tensor    # 0-d int64 (pool-overflow losses)
    dropped_lb: torch.Tensor  # [G] min lb ever dropped (INVALID = none)


def _group_min(values: torch.Tensor, gids: torch.Tensor, g: int):
    """Per-group minimum of values [N] ([G], INVALID for empty groups)."""
    out = torch.full((g,), INVALID, dtype=torch.float32, device=values.device)
    return out.scatter_reduce_(0, gids, values, reduce="amin")


def _count_less(a: torch.Tensor, v: torch.Tensor, strict: bool):
    """The number of entries of sorted `a` [n] below v (strict) or at most
    v, per query v [m]: JAX's binary search (`_count_less`) as
    `torch.searchsorted` (right=False counts a < v, right=True a <= v)."""
    return torch.searchsorted(a, v, right=not strict)


def _merge_sorted(a_lb, b_lb, a_payload, b_payload):
    """Stable merge of two lb-sorted runs, a first on ties: (lb [Na+Nb],
    [payload [Na+Nb, ...] for each pair of payloads]).  Each element's
    place is its index in its run plus the count of the other run's
    elements that go before it; the places form one permutation."""
    na, nb = a_lb.shape[0], b_lb.shape[0]
    dev = a_lb.device
    pos_a = torch.arange(na, device=dev) + _count_less(b_lb, a_lb, True)
    pos_b = torch.arange(nb, device=dev) + _count_less(a_lb, b_lb, False)
    inv = torch.empty(na + nb, dtype=torch.int64, device=dev)
    inv[pos_a] = torch.arange(na, device=dev)
    inv[pos_b] = na + torch.arange(nb, device=dev)
    lb = torch.cat([a_lb, b_lb])[inv]
    return lb, [torch.cat([pa, pb])[inv] for pa, pb in zip(a_payload,
                                                           b_payload)]


def workspace_bytes(g: int, nl: int) -> int:
    """One block's workspace for G groups and nl lanes (csrc/pool_step.cu's
    ws_bytes): 8 B a group and a sort slot (nl rounded up to a power of
    two), 20 B more a group, 16 B a lane and one int, in 16-byte units."""
    p2 = 1 << max(0, nl - 1).bit_length()
    b = 8 * (g + p2) + 4 * (5 * g + 4 * nl + 1)
    return -(-b // 16) * 16


def plan_cluster(cp: int, nl: int) -> int:
    """The cluster's blocks for a pool of cp slots and nl lanes: one per
    ENTRIES_PER_BLOCK old entries, 1 to MAX_CLUSTER."""
    return min(MAX_CLUSTER, max(1, -(-(cp - nl) // ENTRIES_PER_BLOCK)))


def traffic(g: int, cp: int, nl: int):
    """The least bytes of one commit: the pool read and written (28 B a
    slot: lb, int64 gid, center, span), the lanes' lb and ub and their
    next inputs (16 B a lane), the per-group state read and written (64 B a
    group: best_err, best_ub, best_t, active, evaluated, dropped_lb)."""
    return 56.0 * cp + 16.0 * nl + 64.0 * g


class CommitBuffers:
    """What a commit writes besides the new state: `lane_gid` [L] int32 and
    `gam_t` [L] (the next step's lane-kernel inputs) and `live` [1] int32
    (any group active); on the card also the kernel's two output states and
    its global scratch.  Built from the pool's first state, whose lane
    inputs and live flag it starts with."""

    def __init__(self, s: PoolState, lanes: int):
        nl = min(lanes, s.lbs.shape[0])
        self.lane_gid = s.gids[:nl].to(torch.int32)
        self.gam_t = geo.translation_uncertainty_radius(
            s.spans[:nl]).contiguous()
        self.live = torch.any(s.active).to(torch.int32).reshape(1)
        self._states = None
        self.scratch = None

    def target(self, s: PoolState) -> PoolState:
        """The output state the kernel writes after s: the one of two
        buffer states that s is not (allocated like s at the first call)."""
        if self._states is None:
            self._states = [s._replace(**{
                f: torch.empty_like(getattr(s, f)) for f in s._fields
                if f != "steps"}) for _ in range(2)]
        a, b = self._states
        return b if s.lbs.data_ptr() == a.lbs.data_ptr() else a


def pool_commit_plain(s: PoolState, lb_e, ub_e, share, min_span: float,
                      sse_threshold: float,
                      buf: Optional[CommitBuffers] = None,
                      pool_update: str = "sort",
                      err_share_axis=None) -> PoolState:
    """Plain torch version of `pool_commit`, on any device, for both pool
    updates: the state after one step whose lanes (the first L = lb_e's
    length slots of s) evaluated to (lb_e, ub_e).  share [G] int64 or None:
    the group whose incumbent each group takes (-1 none; global ids,
    resolved against best_err all-gathered over `err_share_axis` when that
    axis is sharded).  With `buf`, also writes the next lane inputs and the
    live flag into it."""
    dev = s.lbs.device
    g, cp, nl = s.best_err.shape[0], s.lbs.shape[0], lb_e.shape[0]
    pop_lb, pop_gid = s.lbs[:nl], s.gids[:nl]
    pop_c, pop_s = s.centers[:nl], s.spans[:nl]
    lane_valid = ((pop_lb < INVALID) & (pop_lb < s.best_err[pop_gid])
                  & s.active[pop_gid])
    lb_e = torch.where(lane_valid, lb_e, BIG)
    ub_e = torch.where(lane_valid, ub_e, BIG)

    # Per-group incumbent updates via one-hot reductions [L, G].
    onehot = pop_gid[:, None] == torch.arange(g, device=dev)[None, :]
    ub_grid = torch.where(onehot, ub_e[:, None], BIG)
    grp_min_ub, grp_arg = torch.min(ub_grid, dim=0)         # first lane
    best_ub = torch.where(s.active, torch.minimum(s.best_ub, grp_min_ub),
                          s.best_ub)
    improve = s.active & (grp_min_ub < s.best_err)
    best_err = torch.where(improve, grp_min_ub, s.best_err)
    best_t = torch.where(improve[:, None], pop_c[grp_arg], s.best_t)
    if share is not None:
        pool_err = (err_share_axis.all_gather(best_err)
                    if sharded(err_share_axis) else best_err)
        donor = pool_err[torch.clamp(share, min=0)]
        best_err = torch.where(share >= 0, torch.minimum(best_err, donor),
                               best_err)

    # Children inherit the evaluated lb (fgoicp.cpp:159-166).
    split = lane_valid & (lb_e < best_err[pop_gid]) & (pop_s >= min_span)
    ch_c, ch_s = geo.split_octree(pop_c, pop_s)             # [L, 8, 3]
    ch_lb = torch.where(split, lb_e, INVALID)[:, None].expand(nl, 8)
    ch_gid = pop_gid[:, None].expand(nl, 8)

    if pool_update == "sort":
        all_lb = torch.cat([s.lbs[nl:], ch_lb.reshape(-1)])
        all_gid = torch.cat([s.gids[nl:], ch_gid.reshape(-1)])
        all_c = torch.cat([s.centers[nl:], ch_c.reshape(-1, 3)])
        all_s = torch.cat([s.spans[nl:], ch_s.reshape(-1)])
        # Re-check dominance against the fresher incumbent and inactive
        # groups before sorting (ref pops-and-drops, fgoicp.cpp:127).
        keep = ((all_lb < INVALID) & (all_lb < best_err[all_gid])
                & s.active[all_gid])
        all_lb = torch.where(keep, all_lb, INVALID)
        order = torch.argsort(all_lb, stable=True)
        all_gid, all_c, all_s = all_gid[order], all_c[order], all_s[order]
        all_lb = all_lb[order]
        rest_lb = all_lb[cp:]
    else:
        # The children's keys: the parents' sorted stably, repeated.
        par_key = torch.where(split, lb_e, INVALID)
        par_order = torch.argsort(par_key, stable=True)
        b_lb = par_key[par_order].repeat_interleave(8)
        all_lb, (all_gid, all_c, all_s) = _merge_sorted(
            s.lbs[nl:], b_lb,
            (s.gids[nl:], s.centers[nl:], s.spans[nl:]),
            (ch_gid[par_order].reshape(-1), ch_c[par_order].reshape(-1, 3),
             ch_s[par_order].reshape(-1)))
        keep = ((all_lb < INVALID) & (all_lb < best_err[all_gid])
                & s.active[all_gid])
        rest_lb = torch.where(keep[cp:], all_lb[cp:], INVALID)
    n_valid = torch.sum(keep)
    dropped = s.dropped + torch.clamp(n_valid - cp, min=0)
    # Certificate soundness under overflow: the per-group minimum lb
    # among dropped (still-valid) nodes clamps the group's lb later.
    dropped_lb = torch.minimum(
        s.dropped_lb, _group_min(rest_lb, all_gid[cp:], g))
    new_lb, new_gid = all_lb[:cp], all_gid[:cp]

    minlb = _group_min(new_lb, new_gid, g)
    converged = (best_err - minlb) < sse_threshold
    empty = minlb >= INVALID
    evaluated = s.evaluated + torch.sum(onehot & lane_valid[:, None], dim=0)
    new = PoolState(
        lbs=new_lb, gids=new_gid, centers=all_c[:cp], spans=all_s[:cp],
        best_err=best_err, best_ub=best_ub, best_t=best_t,
        active=s.active & ~(converged | empty), steps=s.steps + 1,
        evaluated=evaluated, dropped=dropped, dropped_lb=dropped_lb)
    if buf is not None:
        buf.lane_gid.copy_(new.gids[:nl])
        buf.gam_t.copy_(geo.translation_uncertainty_radius(new.spans[:nl]))
        buf.live.copy_(torch.any(new.active).reshape(1))
    return new


def _check(s: PoolState, lb_e, ub_e, share, buf):
    """The state's, lanes' and buffers' shapes, dtypes and device; returns
    (device, G, CP, L)."""
    g, cp = s.best_err.shape[0], s.lbs.shape[0]
    nl = buf.lane_gid.shape[0]
    device = s.lbs.device
    want = dict(lbs=((cp,), torch.float32), gids=((cp,), torch.int64),
                centers=((cp, 3), torch.float32),
                spans=((cp,), torch.float32),
                best_err=((g,), torch.float32), best_ub=((g,), torch.float32),
                best_t=((g, 3), torch.float32), active=((g,), torch.bool),
                evaluated=((g,), torch.int64), dropped=((), torch.int64),
                dropped_lb=((g,), torch.float32))
    want.update(lb_e=((nl,), torch.float32), ub_e=((nl,), torch.float32),
                share=((g,), torch.int64), lane_gid=((nl,), torch.int32),
                gam_t=((nl,), torch.float32), live=((1,), torch.int32))
    tensors = {f: getattr(s, f) for f in s._fields if f != "steps"}
    tensors.update(lb_e=lb_e, ub_e=ub_e, share=share, lane_gid=buf.lane_gid,
                   gam_t=buf.gam_t, live=buf.live)
    if share is None:
        del tensors["share"]
    if not (g >= 1 and 1 <= nl <= cp and cp + 8 * nl < 2 ** 31):
        raise ValueError(f"pool_commit: needs G >= 1 and 1 <= L <= CP with "
                         f"CP + 8 L < 2^31, got G {g}, CP {cp}, L {nl}")
    for name, a in tensors.items():
        shape, dtype = want[name]
        if tuple(a.shape) != shape or a.dtype != dtype \
                or a.device != device or not a.is_contiguous():
            raise ValueError(
                f"pool_commit: {name} must be a contiguous {dtype} tensor "
                f"of shape {shape} on {device}, got {a.dtype} "
                f"{tuple(a.shape)} on {a.device}")
    return device, g, cp, nl


def _ptr(a):
    return None if a is None else a.data_ptr()


def pool_commit(s: PoolState, lb_e, ub_e, share, min_span: float,
                sse_threshold: float, buf: CommitBuffers) -> PoolState:
    """The state after one "sort"-update step whose lanes (the first L =
    lb_e's length slots of s) evaluated to (lb_e, ub_e) [L], in one launch
    on the card; share [G] int64 or None (-1: no twin).  Writes the next
    lane inputs and the live flag into `buf`, and on the card the state
    into one of its two buffer states."""
    device, g, cp, nl = _check(s, lb_e, ub_e, share, buf)
    if device.type == "cpu":
        return pool_commit_plain(s, lb_e, ub_e, share, min_span,
                                 sse_threshold, buf)
    out = buf.target(s)
    cluster = plan_cluster(cp, nl)
    ws = workspace_bytes(g, nl)
    if ws > SMEM_LIMIT and (buf.scratch is None
                            or buf.scratch.numel() < cluster * ws):
        buf.scratch = torch.empty(cluster * ws, dtype=torch.uint8,
                                  device=device)
    scratch = buf.scratch if ws > SMEM_LIMIT else None
    lib = build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        build.check(lib.fgoicp_pool_commit(
            s.lbs.data_ptr(), s.gids.data_ptr(), s.centers.data_ptr(),
            s.spans.data_ptr(), s.best_err.data_ptr(), s.best_ub.data_ptr(),
            s.best_t.data_ptr(), s.active.data_ptr(), s.evaluated.data_ptr(),
            s.dropped.data_ptr(), s.dropped_lb.data_ptr(), lb_e.data_ptr(),
            ub_e.data_ptr(), _ptr(share), g, cp, nl, min_span, sse_threshold,
            geo.SQRT3, cluster, SMEM_LIMIT, _ptr(scratch),
            out.lbs.data_ptr(), out.gids.data_ptr(), out.centers.data_ptr(),
            out.spans.data_ptr(), out.best_err.data_ptr(),
            out.best_ub.data_ptr(), out.best_t.data_ptr(),
            out.active.data_ptr(), out.evaluated.data_ptr(),
            out.dropped.data_ptr(), out.dropped_lb.data_ptr(),
            buf.lane_gid.data_ptr(), buf.gam_t.data_ptr(),
            buf.live.data_ptr(), stream), "pool_commit")
    pool_commit.launches += 1
    new = out._replace(steps=s.steps + 1)
    debug.check("pool_commit", new.lbs, new.best_err, new.best_ub,
                new.dropped_lb)
    return new


pool_commit.launches = 0
