"""The nested Go-ICP BnB with the outer SO(3) frontier on the device
(EngineConfig.outer_mode="device").

Counterpart of `fgoicp_tpu/ops/so3_frontier.py`.  The JAX
package runs the whole nested search as one jitted `lax.while_loop`, a TPU
answer to a fixed dispatch cost per outer step.  Here the frontier is a set
of tensors that stay on the model's device, and a Python loop runs the JAX
body step for step: one host read per outer step (the loop condition and the
incumbent that the pooled inner BnB takes as a float), and one copy of the
whole state to the host when the caller retrieves it (`to_host`).  Both,
and every other copy of a state tensor (`as_numpy`), go through
`utils/trace.to_host`, which counts them in the request's host reads.

Semantics, as in the JAX package and the host loop (reference
fgoicp/fgoicp.cpp:32-100):
  * best-first pop of `rotation_batch` cubes per outer step;
  * octree split; popped nodes whose children would fall below
    rotation_min_span are terminal leaves (fgoicp.cpp:53): one still
    claiming an improvement gets a priority ICP lane before it closes (or
    is requeued unchanged when no lane is free), and every closed leaf's lb
    folds into closed_lb, so exhaustion cannot fake a certificate;
  * SO(3) membership: children overlapping-but-outside re-enter the
    frontier with the parent's lb, unevaluated (fgoicp.cpp:61-66);
    non-overlapping children are discarded;
  * one pooled inner R^3 BnB (ops/pool_frontier.py) evaluates the ub
    (fixed rotation) and lb passes of all in-SO(3) children, with twin
    incumbent sharing;
  * lane-filled ICP: the icp_width lowest keys refine each step, leaf
    claims first, then children by ub (with icp_refine_best off, only
    triggered children among those lanes run); they iterate on the proxy
    coreset when one is given and are re-scored exactly on the full clouds;
  * pruning lb >= best_sse (fgoicp.cpp:92) and gap termination
    best_sse - min_lb <= sse_threshold (fgoicp.cpp:44-47).

Certificate under capacity overflow: the frontier has a fixed capacity, and
a subtree dropped from it is gone for good.  The least lb ever dropped is
kept in dropped_lb and folded into `certified_gap`; the caller must check
`certified_gap(state) <= sse_threshold` and re-certify otherwise
(models/goicp.py re-runs the host loop from the device incumbent).

Order and rounding follow the JAX package: the frontier sort is
`torch.argsort(stable=True)` (as `jnp.argsort`), the ICP lanes are the first
icp_width indices of a stable ascending sort of the keys (leaf-claim keys
p_lb - BIG round to one value, and `lax.top_k` breaks their ties by the
lower index; `torch.topk` promises no tie order), and every quantity the
certificate reads is float32 on the device.

On a mesh (parallel/bnb.py::so3_bnb_device_sharded) the frontier is
replicated: every rank runs the same outer step on the same values.  The
children's inner BnB and the ICP lanes slice over `cubes_axis` (each rank
evaluates its rotation_batch * 8 children and its share of the lanes) and
their results are all-gathered before the replicated frontier update; the
search source and the target shard over `points_axis` (psum'd bounds,
pmin-voted ICP and exact SSE, each rank searching its rows of the full
target).  rotation_batch is per cube shard: n_cubes ranks pop
n_cubes * rotation_batch cubes a step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import geometry as geo
from . import pool_frontier
from ..models import icp as icp_model
from ..utils import trace

# The float32 sentinels, as Python floats holding their float32 values, so
# that host comparisons with values read back from the state are exact.
INVALID = float(np.float32(1e30))
BIG = float(np.float32(1e10))


class SO3State(NamedTuple):
    """The device frontier and incumbent; numpy arrays on the host, tensors
    on the device.  Floats are float32, counters int32 (the checkpoint
    format of both packages)."""
    lbs: torch.Tensor       # [C] (INVALID = empty slot), sorted ascending
    ubs: torch.Tensor       # [C] stored child ub (observability only)
    coords: torch.Tensor    # [C, 3] quaternion-cube centers
    spans: torch.Tensor     # [C] half-spans
    ts: torch.Tensor        # [C, 3] inner-BnB best translation per node
    #                         (ICP start of terminal-leaf claim refines)
    best_sse: torch.Tensor  # scalar incumbent
    best_R: torch.Tensor    # [3, 3]
    best_t: torch.Tensor    # [3]
    dropped_lb: torch.Tensor  # scalar: min lb lost to frontier overflow
    closed_lb: torch.Tensor   # scalar: min lb of closed terminal leaves
    #   (folded into certified_gap, not into the loop condition: a leaf
    #   cannot be expanded, so the caller's re-certification decides)
    outer_steps: torch.Tensor
    nodes_expanded: torch.Tensor     # splittable cubes popped
    children_evaluated: torch.Tensor
    inner_nodes: torch.Tensor
    icp_runs: torch.Tensor           # ICP lanes executed
    icp_triggered: torch.Tensor      # lanes passing the trigger
    pruned: torch.Tensor
    # Incumbent-improvement ring of capacity H: once full, the last slot
    # keeps being overwritten, so the final incumbent is always recorded;
    # hist_len saturates at H.
    hist_sse: torch.Tensor   # [H]
    hist_R: torch.Tensor     # [H, 3, 3]
    hist_t: torch.Tensor     # [H, 3]
    hist_step: torch.Tensor  # [H] outer step of each improvement
    hist_len: torch.Tensor   # scalar


_INT_FIELDS = frozenset((
    "outer_steps", "nodes_expanded", "children_evaluated", "inner_nodes",
    "icp_runs", "icp_triggered", "pruned", "hist_step", "hist_len"))


def as_numpy(a) -> np.ndarray:
    """A numpy array of a tensor (copied to the host) or an array-like."""
    if isinstance(a, torch.Tensor):
        return trace.to_host(a.detach())
    return np.asarray(a)


def initial_state(capacity: int, history_capacity: int = 32,
                  best_sse=BIG, best_R=None, best_t=None,
                  cells=None) -> SO3State:
    """A fresh SO3State of numpy arrays.

    cells: optional [(x, y, z, half_span), ...] seed frontier replacing the
    full quaternion cube (fgoicp.cpp:36), for partitioned runs where each
    process searches its own sub-cubes.  Seed lbs are 0.
    """
    cap, hc = capacity, history_capacity
    lbs = np.full((cap,), INVALID, np.float32)
    coords = np.zeros((cap, 3), np.float32)
    spans = np.zeros((cap,), np.float32)
    if cells is None:
        cells = [(0.0, 0.0, 0.0, 1.0)]
    if len(cells) > cap:
        raise ValueError(f"{len(cells)} seed cells > capacity {cap}")
    for i, (x, y, z, span) in enumerate(cells):
        lbs[i] = 0.0
        coords[i] = (x, y, z)
        spans[i] = span
    return SO3State(
        lbs=lbs, ubs=np.full((cap,), BIG, np.float32),
        coords=coords, spans=spans,
        ts=np.zeros((cap, 3), np.float32),
        best_sse=np.float32(as_numpy(best_sse)),
        best_R=np.asarray(
            np.eye(3) if best_R is None else as_numpy(best_R), np.float32),
        best_t=np.asarray(
            np.zeros(3) if best_t is None else as_numpy(best_t), np.float32),
        dropped_lb=np.float32(INVALID),
        closed_lb=np.float32(INVALID),
        outer_steps=np.int32(0), nodes_expanded=np.int32(0),
        children_evaluated=np.int32(0), inner_nodes=np.int32(0),
        icp_runs=np.int32(0), icp_triggered=np.int32(0),
        pruned=np.int32(0),
        hist_sse=np.full((hc,), BIG, np.float32),
        hist_R=np.zeros((hc, 3, 3), np.float32),
        hist_t=np.zeros((hc, 3), np.float32),
        hist_step=np.zeros((hc,), np.int32),
        hist_len=np.int32(0))


def state_from_arrays(arrays: dict) -> SO3State:
    """An SO3State from a checkpoint's field -> array dict.

    Fields that older checkpoints lack get sound defaults: ts = 0 (leaf
    refines start from the cube origin) and closed_lb = INVALID (no leaf
    had been closed when the state was written).
    """
    a = dict(arrays)
    cap = np.asarray(a["lbs"]).shape[0]
    a.setdefault("ts", np.zeros((cap, 3), np.float32))
    a.setdefault("closed_lb", np.float32(INVALID))
    return SO3State(**{f: a[f] for f in SO3State._fields})


def merge_states(states) -> SO3State:
    """Merge several SO3States, one per process of a partitioned run, into
    one numpy state for elastic recovery (models/goicp.py:load_checkpoints).

    The partition keeps every unexplored subtree in exactly one frontier, so
    the union of the frontiers plus the min-sse incumbent covers the whole
    region not yet pruned.  Rows past the shared capacity spill into
    dropped_lb (the device loop's own overflow rule).  Counters sum, so a
    consumer of outer_steps as a step budget must anchor it at the resumed
    value (models/goicp.py does).  The ring of the incumbent's state is
    kept.
    """
    states = [SO3State(*(as_numpy(f) for f in s)) for s in states]
    cap = states[0].lbs.shape[0]
    hc = states[0].hist_sse.shape[0]
    for s in states[1:]:
        if s.lbs.shape[0] != cap or s.hist_sse.shape[0] != hc:
            raise ValueError(
                "cannot merge SO3States with different capacities")
    lbs = np.concatenate([s.lbs for s in states])
    ubs = np.concatenate([s.ubs for s in states])
    coords = np.concatenate([s.coords for s in states])
    spans = np.concatenate([s.spans for s in states])
    ts = np.concatenate([s.ts for s in states])
    order = np.argsort(lbs, kind="stable")
    dropped = min(float(s.dropped_lb) for s in states)
    spill = lbs[order[cap:]]
    spill = spill[spill < INVALID]
    if spill.size:
        dropped = min(dropped, float(spill.min()))
    order = order[:cap]
    k = int(np.argmin([float(s.best_sse) for s in states]))
    best = states[k]

    def tot(f):
        return np.int32(sum(int(getattr(s, f)) for s in states))

    return SO3State(
        lbs=np.asarray(lbs[order], np.float32),
        ubs=np.asarray(ubs[order], np.float32),
        coords=np.asarray(coords[order], np.float32),
        spans=np.asarray(spans[order], np.float32),
        ts=np.asarray(ts[order], np.float32),
        best_sse=np.float32(best.best_sse),
        best_R=np.asarray(best.best_R, np.float32),
        best_t=np.asarray(best.best_t, np.float32),
        dropped_lb=np.float32(dropped),
        closed_lb=np.float32(min(float(s.closed_lb) for s in states)),
        outer_steps=tot("outer_steps"),
        nodes_expanded=tot("nodes_expanded"),
        children_evaluated=tot("children_evaluated"),
        inner_nodes=tot("inner_nodes"), icp_runs=tot("icp_runs"),
        icp_triggered=tot("icp_triggered"), pruned=tot("pruned"),
        hist_sse=np.asarray(best.hist_sse, np.float32),
        hist_R=np.asarray(best.hist_R, np.float32),
        hist_t=np.asarray(best.hist_t, np.float32),
        hist_step=np.asarray(best.hist_step, np.int32),
        hist_len=np.int32(best.hist_len))


def certified_gap(s: SO3State) -> float:
    """The optimality gap the state certifies: the incumbent minus the
    lowest lower bound anywhere (frontier minimum, overflow drops, closed
    leaves), in float32.  <= sse_threshold means certified optimal; larger
    means the search ended (overflow, max_outer, a closed claim leaf)
    without a certificate and the caller must re-certify.  An empty
    frontier with nothing dropped or closed certifies exhaustively (-BIG).
    """
    floor = np.minimum(np.minimum(np.float32(as_numpy(s.lbs)[0]),
                                  np.float32(as_numpy(s.dropped_lb))),
                       np.float32(as_numpy(s.closed_lb)))
    if floor >= np.float32(INVALID):
        return -BIG
    return float(np.float32(as_numpy(s.best_sse)) - floor)


def to_device(s: SO3State, device) -> SO3State:
    """The state as tensors on `device` (float32, counters int32), staged
    through one host-to-device copy."""
    arrays = [np.asarray(as_numpy(a), np.int32 if f in _INT_FIELDS
                         else np.float32)
              for f, a in zip(SO3State._fields, s)]
    buf = torch.from_numpy(np.concatenate(
        [a.reshape(-1).view(np.float32) for a in arrays])).to(device)
    out, k = [], 0
    for f, a in zip(SO3State._fields, arrays):
        t = buf[k:k + a.size].reshape(a.shape)
        out.append(t.view(torch.int32) if f in _INT_FIELDS else t)
        k += a.size
    return SO3State(*out)


def to_host(s: SO3State) -> SO3State:
    """The state's tensors as numpy arrays, in one device-to-host copy."""
    flat = [t.reshape(-1).view(torch.float32) if f in _INT_FIELDS
            else t.reshape(-1) for f, t in zip(SO3State._fields, s)]
    buf = trace.to_host(torch.cat(flat))
    out, k = [], 0
    for f, t in zip(SO3State._fields, s):
        a = buf[k:k + t.numel()]
        out.append((a.view(np.int32) if f in _INT_FIELDS else a)
                   .reshape(tuple(t.shape)))
        k += t.numel()
    return SO3State(*out)


def so3_bnb_device(backend, pct, pcs, search_pcs, best_sse0, best_R0,
                   best_t0, sse_threshold,
                   point_weights=None, point_deltas=None,
                   rotation_batch: int = 16, capacity: int = 16384,
                   max_outer: int = 10000,
                   rotation_min_span: float = 0.05,
                   translation_min_span: float = 0.1,
                   pool_lanes: int = 1024, pool_capacity: int = 32768,
                   ref_compat_gamma: bool = False,
                   icp_width: int = 16, icp_max_iter: int = 100,
                   icp_convergence=0.005,
                   icp_trigger_factor=1.8,
                   icp_search_target=None,
                   icp_search_src=None,
                   icp_search_trim: Optional[int] = None,
                   trim_keep: Optional[int] = None,
                   points_axis=None,
                   trim_ns: Optional[int] = None,
                   icp_refine_best: bool = True,
                   cubes_axis=None, n_cubes: int = 1,
                   history_capacity: int = 32,
                   init_state: Optional[SO3State] = None,
                   pool_update: str = "sort", point_order=None,
                   device=None) -> SO3State:
    """Run the nested BnB with the frontier on `device` (default: pct's);
    returns the final SO3State as tensors there.

    pct [nt, 3]: full target (exact ICP scoring); pcs [ns, 3]: full source;
    search_pcs: bound-evaluation source (cluster representatives or pcs),
    with point_weights / point_deltas for clusters and point_order, the
    proxy lane kernels' `cuda_bounds.source_order` of search_pcs.
    best_sse0 / R0 / t0: the incumbent seed (the initial ICP), ignored when
    init_state is given (the state carries its own).  icp_search_target:
    optional smaller ICP iteration target (the proxy coreset), with
    icp_search_src / icp_search_trim the source subsample; the poses are
    re-scored exactly on pct either way.

    Resumable: `init_state` (a previous call's state, a checkpoint's, or
    initial_state()) continues in place of the root frontier; `max_outer`
    compares against the absolute outer_steps counter, so a chunked caller
    passes `int(state.outer_steps) + chunk`.

    Mesh (module doc): points_axis / cubes_axis mesh axes, with n_cubes the
    size of cubes_axis; search_pcs, point_weights and point_deltas are then
    this rank's point shards, pct stays the full target (the ICP and the
    exact SSE search this rank's rows of it).

    The loop reads the frontier once per outer step and once at exit; the
    inner BnB and the ICPs read the host once per step / iteration as well
    (each a host read of the request, utils/trace.py).
    """
    if (1 if cubes_axis is None else cubes_axis.size) != n_cubes:
        raise ValueError("n_cubes must be the size of cubes_axis")
    dev = torch.device(device) if device is not None else pct.device
    b = rotation_batch * n_cubes   # cubes popped per outer step
    g = b * 8                      # children per outer step
    g_loc = rotation_batch * 8     # children evaluated on this rank
    cap = capacity
    if cap < g:
        raise ValueError(
            f"so3 capacity {cap} cannot hold one batch's children "
            f"(8 * rotation_batch * n_cubes = {g}); raise so3_capacity")
    # The ICP lanes slice evenly over the cube shards: the width rounds up
    # to a multiple of n_cubes (g always is one).
    w_icp = min(-(-min(icp_width, g) // n_cubes) * n_cubes, g)
    w_loc = w_icp // n_cubes
    c_idx = 0 if cubes_axis is None else cubes_axis.index
    share = torch.cat([torch.full((g_loc,), -1, dtype=torch.int64),
                       torch.arange(g_loc, dtype=torch.int64)]).to(dev)
    fix2 = torch.cat([torch.ones(g_loc, dtype=torch.bool),
                      torch.zeros(g_loc, dtype=torch.bool)]).to(dev)

    def gather(a):
        """This rank's per-child (or per-lane) results, gathered over the
        cube shards."""
        return a if cubes_axis is None else cubes_axis.all_gather(a)

    if init_state is None:
        init_state = initial_state(cap, history_capacity, best_sse0,
                                   best_R0, best_t0)
    else:
        shapes = (as_numpy(init_state.lbs).shape[0],
                  as_numpy(init_state.hist_sse).shape[0])
        if shapes != (cap, history_capacity):
            raise ValueError(
                f"init_state shapes (capacity {shapes[0]}, history "
                f"{shapes[1]}) do not match so3_capacity={cap} / "
                f"history_capacity={history_capacity}")
    steps = int(as_numpy(init_state.outer_steps))
    s = to_device(init_state, dev)
    thr32 = float(np.float32(sse_threshold))
    thr = torch.tensor(thr32, dtype=torch.float32, device=dev)
    trig_factor = torch.tensor(icp_trigger_factor, dtype=torch.float32,
                               device=dev)
    i32 = lambda m: torch.sum(m, dtype=torch.int32)

    while True:
        # The loop condition (best_sse - lbs[0] > thr, a live frontier
        # head) and the incumbent for the inner BnB: one read.  The
        # reachable floor only: dropped_lb holds the certificate open but
        # not the loop (certified_gap).
        if steps >= max_outer:
            break
        best_f, lb0, gap = trace.to_host(torch.stack(
            [s.best_sse, s.lbs[0], s.best_sse - s.lbs[0]])).tolist()
        if not (gap > thr32 and lb0 < INVALID):
            break

        # ---- pop the best B cubes and split (fgoicp.cpp:50-66) ----
        p_lb, p_c, p_s, p_t = s.lbs[:b], s.coords[:b], s.spans[:b], s.ts[:b]
        p_valid = p_lb < INVALID
        splittable = p_valid & (p_s / 2.0 >= rotation_min_span)
        terminal = p_valid & ~splittable
        term_claim = terminal & (p_lb < s.best_sse - thr)
        ch_c, ch_s = geo.split_octree(p_c, p_s)               # [B, 8, 3]
        overlaps = geo.overlaps_so3(ch_c, ch_s)
        inside = geo.in_so3(ch_c)
        eval_mask = (splittable[:, None] & overlaps & inside).reshape(g)
        requeue_mask = (splittable[:, None] & overlaps
                        & ~inside).reshape(g)
        ch_c = ch_c.reshape(g, 3)
        ch_s = ch_s.reshape(g)
        parent_lb = p_lb[:, None].expand(b, 8).reshape(g)

        # ---- inner R^3 BnB: ub pass + lb pass in one shared pool, over
        # this rank's slice of the children ----
        R = geo.quat_cube_to_matrix(ch_c)
        sl = slice(c_idx * g_loc, (c_idx + 1) * g_loc)
        R_l, ch_s_l, eval_l = R[sl], ch_s[sl], eval_mask[sl]
        st = pool_frontier.bnb_r3_pooled(
            backend, search_pcs, torch.cat([R_l, R_l]),
            torch.cat([ch_s_l, ch_s_l]), fix2, best_f, thr32,
            group_active=torch.cat([eval_l, eval_l]),
            min_span=translation_min_span, lanes=pool_lanes,
            capacity=pool_capacity, ref_compat_gamma=ref_compat_gamma,
            trim_keep=trim_keep, point_weights=point_weights,
            point_deltas=point_deltas, err_share_from=share,
            trim_ns=trim_ns, pool_update=pool_update,
            point_order=point_order, points_axis=points_axis,
            lockstep_axes=() if cubes_axis is None else (cubes_axis,))
        ub = gather(torch.where(eval_l, st.best_ub[:g_loc], BIG))
        t_g = gather(st.best_t[:g_loc])
        lb_g = gather(torch.minimum(
            torch.minimum(st.best_ub[g_loc:], st.best_err[g_loc:]),
            st.dropped_lb[g_loc:]))
        inner_ev = i32(st.evaluated)
        if cubes_axis is not None:
            inner_ev = cubes_axis.psum(inner_ev)

        # ---- lane-filled ICP: popped terminal-leaf claims first (their
        # ubs are floored by the inner min_span), then children by ub ----
        cand_R = torch.cat([geo.quat_cube_to_matrix(p_c), R])
        cand_t = torch.cat([p_t, t_g])
        leaf_key = torch.where(term_claim, p_lb - BIG, BIG)      # [B]
        child_key = torch.where(eval_mask, ub, BIG)              # [G]
        key = torch.cat([leaf_key, child_key])                   # [B+G]
        sel = torch.sort(key, stable=True).indices[:w_icp]
        trig_all = torch.cat([term_claim,
                              eval_mask & (ub < s.best_sse * trig_factor)])
        trig = trig_all[sel]
        sel_ok = (key[sel] < BIG) if icp_refine_best else trig
        got_lane = torch.zeros(b + g, dtype=torch.bool, device=dev) \
            .index_put((sel,), sel_ok)
        # Each rank refines its w_loc-lane slice of the selection.
        sel_l = sel[c_idx * w_loc:(c_idx + 1) * w_loc]
        ok_l = sel_ok[c_idx * w_loc:(c_idx + 1) * w_loc]
        if icp_search_target is None:
            sse_i, R_i, t_i = icp_model.icp_batched(
                pct, pcs, cand_R[sel_l], cand_t[sel_l], active=ok_l,
                max_iter=icp_max_iter, convergence_threshold=icp_convergence,
                trim_keep=trim_keep, target_axis=points_axis)
        else:
            # Iterate on the replicated proxy coreset (and source
            # subsample), then re-score exactly on the sharded target.
            it_src = pcs if icp_search_src is None else icp_search_src
            it_trim = trim_keep if icp_search_src is None \
                else icp_search_trim
            _, R_i, t_i = icp_model.icp_batched(
                icp_search_target, it_src, cand_R[sel_l], cand_t[sel_l],
                active=ok_l, max_iter=icp_max_iter,
                convergence_threshold=icp_convergence, trim_keep=it_trim)
            sse_i = icp_model.exact_sse_batched(pct, pcs, R_i, t_i,
                                                trim_keep=trim_keep,
                                                target_axis=points_axis)
        sse_i, R_i, t_i = gather(sse_i), gather(R_i), gather(t_i)
        sse_i = torch.where(sel_ok, sse_i, BIG)
        # Index with a 1-element tensor: a 0-d index would read the host.
        k = torch.argmin(sse_i).reshape(1)
        sse_k = sse_i.index_select(0, k)[0]
        improve = sse_k < s.best_sse
        best_sse = torch.where(improve, sse_k, s.best_sse)
        best_R = torch.where(improve, R_i.index_select(0, k)[0], s.best_R)
        best_t = torch.where(improve, t_i.index_select(0, k)[0], s.best_t)

        # ---- incumbent history ring ----
        hidx = torch.clamp(s.hist_len, max=history_capacity - 1) \
            .reshape(1).long()

        def ring(old, new):
            return old.index_put((hidx,), torch.where(
                improve, new, old.index_select(0, hidx)[0])[None])

        hist_sse = ring(s.hist_sse, best_sse)
        hist_R = ring(s.hist_R, best_R)
        hist_t = ring(s.hist_t, best_t)
        hist_step = ring(s.hist_step, s.outer_steps + 1)
        hist_len = torch.clamp(s.hist_len + improve.to(torch.int32),
                               max=history_capacity)

        # ---- prune + push children (fgoicp.cpp:92-96) ----
        keep_eval = eval_mask & (lb_g < best_sse)
        ch_lb = torch.where(keep_eval, lb_g,
                            torch.where(requeue_mask, parent_lb, INVALID))
        ch_ub = torch.where(keep_eval, ub, BIG)
        # Requeued outside-SO(3) children inherit the parent's inner
        # translation with its lb: their eventual leaf-claim refine must not
        # start from t = 0 on translated pairs.
        parent_t = p_t[:, None, :].expand(b, 8, 3).reshape(g, 3)
        ch_t = torch.where(keep_eval[:, None], t_g,
                           torch.where(requeue_mask[:, None], parent_t, 0.0))
        # Claim leaves that got no ICP lane (and still claim against the
        # updated incumbent) requeue unchanged; every other popped terminal
        # leaf closes now and folds its lb into closed_lb.
        requeue_self = term_claim & ~got_lane[:b] \
            & (p_lb < best_sse - thr)
        self_lb = torch.where(requeue_self, p_lb, INVALID)
        self_ub = torch.where(requeue_self, s.ubs[:b], BIG)
        closed_now = torch.where(terminal & ~requeue_self, p_lb, INVALID)
        all_lb = torch.cat([s.lbs[b:], ch_lb, self_lb])
        all_ub = torch.cat([s.ubs[b:], ch_ub, self_ub])
        all_c = torch.cat([s.coords[b:], ch_c, p_c])
        all_s = torch.cat([s.spans[b:], ch_s, p_s])
        all_t = torch.cat([s.ts[b:], ch_t, p_t])
        order = torch.argsort(all_lb, stable=True)
        head = order[:cap]

        s = SO3State(
            lbs=all_lb[head], ubs=all_ub[head], coords=all_c[head],
            spans=all_s[head], ts=all_t[head],
            best_sse=best_sse, best_R=best_R, best_t=best_t,
            dropped_lb=torch.minimum(s.dropped_lb,
                                     torch.min(all_lb[order[cap:]])),
            closed_lb=torch.minimum(s.closed_lb, torch.min(closed_now)),
            outer_steps=s.outer_steps + 1,
            nodes_expanded=s.nodes_expanded + i32(splittable),
            children_evaluated=s.children_evaluated + i32(eval_mask),
            inner_nodes=s.inner_nodes + inner_ev,
            icp_runs=s.icp_runs + i32(sel_ok),
            icp_triggered=s.icp_triggered + i32(trig & sel_ok),
            pruned=s.pruned + i32(eval_mask & (lb_g >= best_sse)),
            hist_sse=hist_sse, hist_R=hist_R, hist_t=hist_t,
            hist_step=hist_step, hist_len=hist_len)
        steps += 1
    return s
