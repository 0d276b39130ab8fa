"""Multi-host Go-ICP: host-partitioned outer BnB + incumbent all-gather.

Counterpart of `fgoicp_tpu/parallel/distributed.py`.  The reference is a
single process on a single GPU.  This layer spreads the OUTER SO(3) search
over hosts: the rotation cube is partitioned across processes (octant
round-robin, recursively for more than 8 hosts), each host runs the whole
nested BnB on its partition on its own device, and a small fixed-size
incumbent message is all-gathered every `multihost_sync_every` outer steps
so every host prunes against the global best.

Protocol (one message per host per round, 18 floats):
    [best_sse, local_min_lb, idle_flag, R(9), t(3), heap_len, steal_max,
     valve_bound]
(valve_bound marks a device-mode host idled by the outer-step safety valve:
it votes idle for termination but CANNOT absorb stolen work, so the steal
plan skips it; always 0 in host mode.)
Each sync round every host adopts the global-min incumbent, then runs up to
`engine.multihost_sync_every` outer steps (staleness bound: the incumbent a
host prunes against is at most that many outer steps old; a stale incumbent
is merely HIGHER, so pruning stays sound) before the next collective.  Every
decision taken at a sync point (termination, incumbent adoption, donor and
recipient selection for work stealing) is a PURE FUNCTION of the gathered
matrix, so all hosts always agree: a host that read its own state there
instead would leave the loop while another re-enters the collective, which
deadlocks.  Global termination fires when
    min_h(best_sse_h) - min_h(local_min_lb_h) <= sse_threshold,
which also covers the all-heaps-empty case (min_lb = +inf).

Work stealing: when the gathered matrix shows at least one idle host and a
non-idle host with >= 2 frontier nodes, a second all-gather moves up to
`steal_max` nodes from the largest frontier to the idle hosts
(round-robin).  Donated nodes leave the donor, so each node lives in exactly
one frontier and the BnB certificate is unaffected.  The second gather runs
iff the shared matrix says so: no host can skip the collective.

The communicator is pluggable.  `TorchDistributedCommunicator` gathers over
a torch.distributed gloo process group (`initialize`), one OS process per
host; `ThreadCommunicator` runs N hosts as threads of one process with the
same semantics.  Both carry the message as float64, bit for bit (gloo moves
the tensor's bytes), so a gloo run and a thread run of the same hosts
gather the same matrices.  The JAX package's wire is float32 and sends
(hi, lo) pairs; `split_f64_to_f32_pairs` / `merge_f32_pairs_to_f64` are kept
for that format.  Gloo, not NCCL: the message is 18 host floats a round,
and NCCL refuses two ranks on one card.

Both outer modes are supported: `outer_mode="host"` steps the host heap
between sync rounds; `outer_mode="device"` runs each host's partition as
multihost_sync_every-step CHUNKS of the device nested BnB
(ops/so3_frontier.py; the partition cells seed the device frontier through
`initial_state(cells=...)`), with one copy of the state to the host per
chunk (`so3_frontier.to_host`), the same 18-float protocol between chunks,
and work stealing as numpy surgery on the lb-sorted SO3State rows.  A device
search that stalls with an open certificate (capacity drops or the step
valve) falls back to the partitioned host loop on ALL ranks together: the
decision is a pure function of the gathered matrix.

Each host runs on one device (`device="cuda"` unless the caller passes
"cpu") or on a device mesh of its own (`mesh=`, parallel/sharding.py): a
world of H x K processes, K = n_cubes x n_points, holds H meshes, host h on
ranks [h K, (h + 1) K) (`make_host_mesh`).  The mesh ranks of one host hold
bit-identical search state (every host decision on a mesh reads only
gathered values), so each mesh position k has a host group of its own,
{h' K + k for every host h'}, and the K groups gather the same matrices:
every rank of every host takes the same sync decisions with no broadcast
inside a host, and a steal moves the same nodes on every mesh rank of the
donor and of the recipients.  The 10x timeout of the first two rounds also
covers the meshes' first collectives (the initial ICP runs on the mesh).
"""

from __future__ import annotations

import datetime
import heapq
import os
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import EngineConfig
from ..models.goicp import GoICP
from ..ops import so3_frontier as so3
from ..utils import logging as log
from ..utils import trace
from .sharding import DEFAULT_TIMEOUT_S, Mesh, make_mesh

_MSG_LEN = 18

_TIMEOUT_HINT = (
    "multi-host allgather timed out or lost a peer: a peer process is "
    "likely dead or hung (or still building the CUDA kernels or running a "
    "long chunk: raise engine.multihost_timeout_s above the worst-case "
    "chunk wall).  The collective cannot recover in place, so this error "
    "is terminal for the process; restart the job from the latest "
    "checkpoint (engine.checkpoint_path / --resume, or "
    "GoICP.load_checkpoints for elastic recovery) with the surviving "
    "hosts.")


def split_f64_to_f32_pairs(vec: np.ndarray) -> np.ndarray:
    """[L] f64 -> [2L] f32 (hi, lo) with hi + lo ~= vec to ~2^-48 relative
    (the lo residual is itself f32-rounded, so ~48-49 of the 52 f64
    mantissa bits survive).  The JAX package's float32 wire format; the
    communicators here send float64 as it is."""
    vec = np.asarray(vec, np.float64)
    hi = vec.astype(np.float32)
    lo = (vec - hi.astype(np.float64)).astype(np.float32)
    return np.concatenate([hi, lo])


def merge_f32_pairs_to_f64(mat: np.ndarray) -> np.ndarray:
    """Inverse of split_f64_to_f32_pairs over the last axis."""
    half = mat.shape[-1] // 2
    return (mat[..., :half].astype(np.float64)
            + mat[..., half:].astype(np.float64))


class ThreadCommunicator:
    """Barrier-synchronized all-gather across N threads of one process."""

    def __init__(self, rank: int, size: int, shared: dict):
        self.rank = rank
        self.size = size
        self._shared = shared

    @classmethod
    def create(cls, n: int) -> Sequence["ThreadCommunicator"]:
        shared = {
            "fill": threading.Barrier(n),
            "drain": threading.Barrier(n),
            "slots": [None] * n,
        }
        return [cls(r, n, shared) for r in range(n)]

    def allgather(self, vec: np.ndarray,
                  timeout: Optional[float] = None) -> np.ndarray:
        s = self._shared
        s["slots"][self.rank] = np.asarray(vec, np.float64).copy()
        try:
            s["fill"].wait(timeout)
            out = np.stack(s["slots"])
            # everyone has read before the next round writes
            s["drain"].wait(timeout)
        except threading.BrokenBarrierError:
            raise RuntimeError(_TIMEOUT_HINT) from None
        return out


class TorchDistributedCommunicator:
    """All-gather over a torch.distributed process group (gloo, one process
    per host; `initialize` brings up the default group, `make_host_mesh`
    the host groups of hosts on meshes).  `group` None is the default
    group; `rank` and `size` are this process's within the group.  The
    message goes as one float64 CPU tensor, so every rank decodes the same
    bits."""

    def __init__(self, group=None):
        import torch.distributed as dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def allgather(self, vec: np.ndarray,
                  timeout: Optional[float] = None) -> np.ndarray:
        import torch.distributed as dist
        mine = torch.from_numpy(np.array(vec, np.float64, copy=True))
        outs = [torch.empty_like(mine) for _ in range(self.size)]
        try:
            work = dist.all_gather(outs, mine, group=self.group,
                                   async_op=True)
            if timeout is None:
                work.wait()
            else:
                work.wait(timeout=datetime.timedelta(seconds=timeout))
        except RuntimeError as err:   # a timeout or a lost peer
            raise RuntimeError(f"{_TIMEOUT_HINT} ({err})") from err
        return torch.stack(outs).numpy()


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: str = "gloo",
               timeout: Optional[float] = None
               ) -> TorchDistributedCommunicator:
    """Join a process group (gloo unless `backend` says otherwise) and
    return its communicator.

    coordinator_address "host:port" (rank 0 listens there) with
    num_processes and process_id; with no address the group reads
    MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK from the environment
    (env://), as `torchrun --nproc_per_node N` sets them.  timeout
    (seconds) bounds the rendezvous and the group's collectives; a peer
    that never joins raises RuntimeError."""
    import torch.distributed as dist
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kw = {} if timeout is None else dict(
        timeout=datetime.timedelta(seconds=timeout))
    try:
        dist.init_process_group(
            backend, init_method=init_method,
            world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id, **kw)
    except RuntimeError as err:   # a rendezvous timeout (DistStoreError)
        raise RuntimeError(
            f"process group rendezvous at {init_method} failed: a peer did "
            f"not join within the timeout ({err})") from err
    return TorchDistributedCommunicator()


def host_communicator(mesh: Mesh, timeout: Optional[float] = None
                      ) -> TorchDistributedCommunicator:
    """The communicator of this rank's host group when the world holds
    one mesh of `mesh.size` ranks a host: every rank at mesh position k
    gathers with position k of every other host.  Every rank must call this
    with its mesh in the same order (it creates all K gloo groups, whatever
    the mesh's backend: the message lives on the host)."""
    import torch.distributed as dist
    k_size = mesh.size
    n_hosts = dist.get_world_size() // k_size
    timeout = DEFAULT_TIMEOUT_S if timeout is None else timeout
    groups = [dist.new_group([h * k_size + k for h in range(n_hosts)],
                             backend="gloo",
                             timeout=datetime.timedelta(seconds=timeout))
              for k in range(k_size)]
    return TorchDistributedCommunicator(groups[mesh.rank])


def make_host_mesh(n_hosts: Optional[int] = None,
                   n_cubes: Optional[int] = None, n_points: int = 1,
                   device="cuda", backend: Optional[str] = None,
                   timeout: Optional[float] = None):
    """(host communicator, mesh) of this rank in a world of n_hosts meshes
    of n_cubes x n_points ranks (torchrun with n_hosts x n_cubes x n_points
    processes, or an initialized group): the meshes first, then the host
    groups, created in the same order on every rank.  n_hosts None: the
    world's ranks over n_cubes x n_points (n_cubes must then be given)."""
    import torch.distributed as dist
    if n_hosts is None:
        if n_cubes is None:
            raise ValueError("make_host_mesh needs n_hosts or n_cubes")
        world = (dist.get_world_size() if dist.is_initialized()
                 else int(os.environ.get("WORLD_SIZE", 1)))
        n_hosts = max(1, world // (n_cubes * n_points))
    mesh = make_mesh(n_cubes, n_points, device=device, backend=backend,
                     timeout=timeout, n_hosts=n_hosts)
    if not dist.is_initialized():   # a world of one process
        (comm,) = ThreadCommunicator.create(1)
        return comm, mesh
    return host_communicator(mesh, timeout), mesh


def partition_root(rank: int, size: int):
    """Recursively split the quaternion cube until there are >= size
    cells; return the cells owned by `rank` (round-robin)."""
    cells = [(0.0, 0.0, 0.0, 1.0)]
    while len(cells) < size:
        nxt = []
        for (x, y, z, span) in cells:
            half = span / 2.0
            for j in range(8):
                nxt.append((x - half + ((j >> 0) & 1) * span,
                            y - half + ((j >> 1) & 1) * span,
                            z - half + ((j >> 2) & 1) * span,
                            half))
        cells = nxt
    return [c for i, c in enumerate(cells) if i % size == rank]


class MultiHostGoICP(GoICP):
    """GoICP over a partition of SO(3), globally synchronized every
    multihost_sync_every outer steps.  `comm` has `rank`, `size` and
    `allgather(vec, timeout) -> [size, len(vec)]`; the other arguments are
    GoICP's (device defaults to "cuda").  `mesh=` runs this host on its own
    device mesh, as GoICP(mesh=...) does, and `comm` is then the host group
    of its mesh position (`make_host_mesh`); engine.mesh_cubes /
    mesh_points with no mesh make one of comm.size hosts' meshes."""

    def __init__(self, pct, pcs, comm, **kwargs):
        e = kwargs.get("engine")
        if kwargs.get("mesh") is None and e is not None and \
                e.mesh_cubes * e.mesh_points > 1:
            kwargs["mesh"] = make_mesh(
                e.mesh_cubes, e.mesh_points,
                device=kwargs.get("device", "cuda"), n_hosts=comm.size)
        super().__init__(pct, pcs, **kwargs)
        self.comm = comm
        self._timeout = (self.engine.multihost_timeout_s
                         if self.engine.multihost_timeout_s > 0 else None)
        self.sync_rounds = 0
        self.idle_rounds = 0
        self.donated_nodes = 0
        self.stolen_nodes = 0
        # Device-mode step valve; re-anchored relative to the resumed
        # state's counter at driver start (_bnb_so3_device_multihost).
        self._device_valve = self._DEVICE_MAX_OUTER

    def root_nodes(self):
        return partition_root(self.comm.rank, self.comm.size)

    def _locally_idle(self) -> bool:
        """True when this host would not run an outer step this round."""
        return not self._heap or self.outer_converged()

    def _round_timeout(self):
        """Dead-peer timeout for the next incumbent gather.  The first two
        rounds absorb one-time costs a liveness timeout must not trip on:
        the kernels' build at first use (nvcc) and the initial ICP before
        round 1, the first outer step or device chunk before round 2; so
        they get 10x."""
        if self._timeout is None:
            return None
        return self._timeout * 10.0 if self.sync_rounds < 2 \
            else self._timeout

    def _message(self) -> np.ndarray:
        msg = np.empty((_MSG_LEN,), np.float64)
        msg[0] = self.best_sse
        # The certificate floor, not just the heap minimum: terminal leaves
        # this host already closed (GoICP._closed_leaf_lb) keep bounding the
        # gap; without the fold every rank's exhausted heap reads as BIG and
        # frontier exhaustion converges with a fake certificate.
        msg[1] = min(self.heap_min_lb(), self._closed_leaf_lb)
        msg[2] = 1.0 if self._locally_idle() else 0.0
        msg[3:12] = np.asarray(self.best_rotation, np.float64).reshape(9)
        msg[12:15] = np.asarray(self.best_translation, np.float64)
        msg[15] = float(len(self._heap))
        # Carried on the wire so the steal payload length is a pure function
        # of the gathered matrix: hosts launched with differing engine
        # configs must still agree on whether and how to enter the second
        # collective, or they deadlock.
        msg[16] = float(max(0, self.engine.multihost_steal_max))
        msg[17] = 0.0   # host mode has no step valve
        return msg

    def _sync_round(self) -> bool:
        """All-gather incumbents; adopt the global best; rebalance work.
        Returns True when the search is globally converged (or exhausted).
        Every decision here is a pure function of the gathered matrix."""
        gathered = self.comm.allgather(self._message(),
                                       timeout=self._round_timeout())
        self.sync_rounds += 1
        k = int(np.argmin(gathered[:, 0]))
        gmin = float(gathered[k, 0])
        if gmin < self.best_sse:
            self.best_sse = gmin
            self.best_rotation = np.asarray(
                gathered[k, 3:12].reshape(3, 3), np.float32)
            self.best_translation = np.asarray(gathered[k, 12:15], np.float32)
            self._record_improvement()
        global_min_lb = float(np.min(gathered[:, 1]))
        # The gap the wire proves: identical on every host.
        self.last_certified_gap = gmin - global_min_lb
        converged = gmin - global_min_lb <= self.sse_threshold
        if not converged:
            # Exhaustion stall: EVERY host idle (locally converged or empty)
            # while closed-leaf floors hold the global gap open.  No step can
            # change the matrix any more (locally converged heaps only hold
            # nodes within their local gap, and closed leaves cannot be
            # expanded), so terminate with the gap honestly OPEN rather than
            # livelock.  The device path's 'stalled' exit is the same rule.
            if bool(np.all(gathered[:, 2] > 0.5)):
                log.warning(
                    f"Multi-host search exhausted with an OPEN certificate "
                    f"gap ({self.last_certified_gap:.3g} > "
                    f"{self.sse_threshold:.3g}): closed terminal leaves "
                    f"bound it; result is the best incumbent WITHOUT an "
                    f"optimality certificate")
                return True
            self._maybe_steal(gathered)
        return converged

    def _maybe_steal(self, gathered: np.ndarray) -> None:
        """Move frontier nodes from the largest heap to idle hosts.  The
        plan (_steal_plan) comes from the shared matrix, so either every
        host enters the payload all-gather with the same length or none
        does.  The donor keeps its best node."""
        plan = self._steal_plan(gathered)
        if plan is None:
            return
        steal_max, donor, absorbing, n_abs = plan
        payload = np.zeros((1 + 9 * steal_max,), np.float64)
        if self.comm.rank == donor:
            n_give = min(steal_max, len(self._heap) - 1)
            top = heapq.heappop(self._heap)
            give = [heapq.heappop(self._heap) for _ in range(n_give)]
            heapq.heappush(self._heap, top)
            payload[0] = float(n_give)
            for i, (lb, _, item) in enumerate(give):
                row8 = tuple(item) + (0.0,) * max(0, 8 - len(item))
                payload[1 + 9 * i:10 + 9 * i] = (lb,) + row8
            self.donated_nodes += n_give
        row = self.comm.allgather(payload, timeout=self._timeout)[donor]
        cnt = int(row[0])
        if absorbing[self.comm.rank] and cnt > 0:
            my_idx = int(np.flatnonzero(absorbing).tolist()
                         .index(self.comm.rank))
            for i in range(cnt):
                if i % n_abs != my_idx:
                    continue
                vals = row[1 + 9 * i:10 + 9 * i]
                heapq.heappush(
                    self._heap,
                    (float(vals[0]), next(self._tie),
                     tuple(float(v) for v in vals[1:9])))
                self.stolen_nodes += 1

    def _steal_plan(self, gathered: np.ndarray):
        """The shared pure-function core of both steal protocols: from the
        gathered matrix alone, whether the payload collective runs and who
        takes part.  Returns (steal_max, donor, absorbing_mask,
        n_absorbing) or None.  `absorbing` leaves out hosts idled by the
        device-mode step valve (msg[17]): they vote idle for termination
        but cannot expand donated work."""
        steal_max = int(np.min(gathered[:, 16]))
        idle = gathered[:, 2] > 0.5
        absorbing = idle & ~(gathered[:, 17] > 0.5)
        sizes = gathered[:, 15]
        n_abs = int(np.sum(absorbing))
        donor = int(np.argmax(np.where(~idle, sizes, -1.0)))
        if steal_max == 0 or n_abs == 0 or idle[donor] or sizes[donor] < 2:
            return None
        return steal_max, donor, absorbing, n_abs

    # ----- device outer mode: chunked device calls + sync rounds -----
    #
    # Each host seeds its SO3State frontier from its partition cells and
    # runs the whole nested BnB on its device in multihost_sync_every-step
    # chunks.  Each chunk's state comes back in one copy (to_host) and the
    # protocol works on numpy: the adopted global best is written into the
    # state, so the next chunk prunes against it, and work stealing moves
    # frontier rows between states (the state is lb-sorted, so rows 1..n
    # are the donor's next-best nodes).

    def _device_floor_idle(self, st):
        """(certificate_floor, reachable_floor, idle, valve_bound) of a
        numpy SO3State.  valve_bound = idled by the outer-step safety
        valve: such a host votes idle but cannot expand anything, so the
        steal plan must not donate to it."""
        reach = float(np.asarray(st.lbs)[0])
        cert = min(reach, float(st.dropped_lb), float(st.closed_lb))
        valve_bound = int(st.outer_steps) >= self._device_valve
        idle = (reach >= so3.INVALID
                or float(st.best_sse) - reach <= self.sse_threshold
                or valve_bound)
        return cert, reach, idle, valve_bound

    def _message_device(self, st) -> np.ndarray:
        cert, _, idle, valve_bound = self._device_floor_idle(st)
        msg = np.empty((_MSG_LEN,), np.float64)
        msg[0] = float(st.best_sse)
        msg[1] = cert
        msg[2] = 1.0 if idle else 0.0
        msg[3:12] = np.asarray(st.best_R, np.float64).reshape(9)
        msg[12:15] = np.asarray(st.best_t, np.float64)
        msg[15] = float(np.sum(np.asarray(st.lbs) < so3.INVALID))
        msg[16] = float(max(0, self.engine.multihost_steal_max))
        msg[17] = 1.0 if valve_bound else 0.0
        return msg

    def _sync_round_device(self, st):
        """All-gather incumbents; adopt the global best into the state;
        rebalance frontier rows.  Returns (status, st), status one of 'run',
        'converged' or 'stalled' (every host idle with the gap still open:
        capacity drops or the step valve; the caller falls back to the host
        loop on all ranks together), a pure function of the matrix."""
        gathered = self.comm.allgather(self._message_device(st),
                                       timeout=self._round_timeout())
        self.sync_rounds += 1
        k = int(np.argmin(gathered[:, 0]))
        gmin = float(gathered[k, 0])
        if gmin < float(st.best_sse):
            st = st._replace(
                best_sse=np.float32(gmin),
                best_R=np.asarray(gathered[k, 3:12].reshape(3, 3),
                                  np.float32),
                best_t=np.asarray(gathered[k, 12:15], np.float32))
        global_min_lb = float(np.min(gathered[:, 1]))
        self.last_certified_gap = gmin - global_min_lb
        if gmin - global_min_lb <= self.sse_threshold:
            return "converged", st
        if bool(np.all(gathered[:, 2] > 0.5)):
            return "stalled", st
        st = self._maybe_steal_device(gathered, st)
        return "run", st

    def _maybe_steal_device(self, gathered: np.ndarray, st):
        """_maybe_steal on the lb-sorted SO3State rows instead of a heap,
        with the same _steal_plan.  The sorts are stable, and rows past the
        capacity fold their least lb into dropped_lb."""
        plan = self._steal_plan(gathered)
        if plan is None:
            return st
        steal_max, donor, absorbing, n_abs = plan
        payload = np.zeros((1 + 9 * steal_max,), np.float64)
        if self.comm.rank == donor:
            lbs = np.array(st.lbs, np.float32)
            ubs = np.array(st.ubs, np.float32)
            coords = np.array(st.coords, np.float32)
            spans = np.array(st.spans, np.float32)
            ts = np.array(st.ts, np.float32)
            n_valid = int(np.sum(lbs < so3.INVALID))
            n_give = min(steal_max, n_valid - 1)
            payload[0] = float(n_give)
            for i in range(n_give):
                r = 1 + i   # row 0 = the donor's best node, kept
                payload[1 + 9 * i:10 + 9 * i] = (
                    lbs[r], coords[r, 0], coords[r, 1], coords[r, 2],
                    spans[r], ubs[r], ts[r, 0], ts[r, 1], ts[r, 2])
            lbs[1:1 + n_give] = so3.INVALID
            ubs[1:1 + n_give] = so3.BIG
            spans[1:1 + n_give] = 0.0
            order = np.argsort(lbs, kind="stable")
            st = st._replace(lbs=lbs[order], ubs=ubs[order],
                             coords=coords[order], spans=spans[order],
                             ts=ts[order])
            self.donated_nodes += n_give
        row = self.comm.allgather(payload, timeout=self._timeout)[donor]
        cnt = int(row[0])
        if absorbing[self.comm.rank] and cnt > 0:
            my_idx = int(np.flatnonzero(absorbing).tolist()
                         .index(self.comm.rank))
            take = np.asarray([row[1 + 9 * i:10 + 9 * i]
                               for i in range(cnt) if i % n_abs == my_idx])
            if len(take):
                cap = np.asarray(st.lbs).shape[0]

                def cat(field, cols):
                    return np.concatenate([np.asarray(field, np.float32),
                                           take[:, cols].astype(np.float32)])

                lbs = cat(st.lbs, 0)
                order = np.argsort(lbs, kind="stable")
                dropped_lb = float(st.dropped_lb)
                spill = lbs[order[cap:]]
                spill = spill[spill < so3.INVALID]
                if spill.size:   # capacity overflow: certificate clamp
                    dropped_lb = min(dropped_lb, float(spill.min()))
                order = order[:cap]
                st = st._replace(
                    lbs=lbs[order], ubs=cat(st.ubs, 5)[order],
                    coords=cat(st.coords, slice(1, 4))[order],
                    spans=cat(st.spans, 4)[order],
                    ts=cat(st.ts, slice(6, 9))[order],
                    dropped_lb=np.float32(dropped_lb))
                self.stolen_nodes += len(take)
        return st

    def _bnb_so3_device_multihost(self) -> bool:
        """Partitioned device-outer search; returns True when it ended with
        an OPEN certificate (all hosts stalled on drops or the valve) and
        the caller must re-certify with the host loop."""
        e = self.engine
        call = self._device_call_fn()
        st = self._resumed_so3_state
        self._resumed_so3_state = None
        if st is None:
            st = so3.initial_state(
                e.so3_capacity, best_sse=self.best_sse,
                best_R=self.best_rotation, best_t=self.best_translation,
                cells=self.root_nodes())
        last = {f: int(getattr(st, f)) for f in self._DEVICE_COUNTERS}
        hist_seen = int(st.hist_len)
        # Relative step valve (GoICP._bnb_so3_device): elastic recovery SUMS
        # outer_steps when merging crash checkpoints, so an absolute cap
        # could start exhausted and idle the host for good.
        self._device_valve = int(st.outer_steps) + self._DEVICE_MAX_OUTER
        last_ckpt_steps = int(st.outer_steps)
        sync_every = max(1, e.multihost_sync_every)
        while True:
            status, st = self._sync_round_device(st)
            if status != "run":
                break
            _, _, idle, _ = self._device_floor_idle(st)
            if idle:
                self.idle_rounds += 1
                continue
            cap = min(int(st.outer_steps) + sync_every, self._device_valve)
            # One copy per chunk: the protocol reads ~20 state fields.
            st = so3.to_host(call(st, cap))
            self._sanitize_device_state(st)
            self._flush_device_counters(st, last)
            # Honor the configured cadence (outer steps between
            # checkpoints), not one file per sync round.
            if e.checkpoint_path and e.checkpoint_every > 0 and \
                    int(st.outer_steps) - last_ckpt_steps >= \
                    e.checkpoint_every:
                self._save_device_checkpoint(st)
                last_ckpt_steps = int(st.outer_steps)
        self._device_adopt(st, hist_seen, last)
        log.debug(f"[host {self.comm.rank}] device BnB {status}: "
                  f"{self.sync_rounds} sync rounds, {self.idle_rounds} "
                  f"idle, {self.donated_nodes} donated / "
                  f"{self.stolen_nodes} stolen, best={self.best_sse}")
        return status == "stalled"

    @trace.spanned("bnb")
    def _branch_and_bound_so3(self):
        if self.engine.outer_mode == "device":
            if not self._bnb_so3_device_multihost():
                return self.best_sse
            log.warning(
                "Multi-host device SO(3) search stalled with an open "
                "certificate gap (frontier drops or the step valve): "
                "re-certifying with the partitioned host loop (raise "
                "engine.so3_capacity to avoid this)")
        self.seed_heap()
        sync_every = max(1, self.engine.multihost_sync_every)
        while True:
            if self._sync_round():
                break
            stepped = False
            for _ in range(sync_every):
                if self._heap and not self.outer_converged():
                    self.outer_step()
                    stepped = True
                else:
                    break
            if not stepped:
                self.idle_rounds += 1
        log.debug(f"[host {self.comm.rank}] BnB done: "
                  f"{self.sync_rounds} sync rounds, {self.idle_rounds} idle, "
                  f"{self.donated_nodes} donated / {self.stolen_nodes} "
                  f"stolen nodes, best={self.best_sse}")
        return self.best_sse


def register_multihost(pct, pcs, comm=None, lut_resolution: float = 0.005,
                       mse_threshold: float = 1e-3,
                       engine: Optional[EngineConfig] = None, mesh=None,
                       **kw):
    """Run multi-host Go-ICP on this host's partition; returns (model, R, t).

    mesh: a Mesh, or an (n_cubes, n_points) pair, or None for
    engine.mesh_cubes x mesh_points (one device a host when that is 1).
    With no `comm`, the host communicator of the torch.distributed world:
    the default group's for one device a host, joining one through
    `initialize()` (env://) first when none is up, or, when the mesh is
    given as its shape, both the host groups and the mesh
    (`make_host_mesh`, a world of hosts x n_cubes x n_points ranks)."""
    e = engine or EngineConfig()
    if mesh is None and e.mesh_cubes * e.mesh_points > 1:
        mesh = (e.mesh_cubes, e.mesh_points)
    if comm is None:
        import torch.distributed as dist
        if isinstance(mesh, tuple):
            comm, mesh = make_host_mesh(
                None, mesh[0], mesh[1], device=kw.get("device", "cuda"))
        elif mesh is not None and mesh.size > 1:
            comm = host_communicator(mesh)
        else:
            comm = (TorchDistributedCommunicator() if dist.is_initialized()
                    else initialize())
    elif isinstance(mesh, tuple):
        mesh = make_mesh(mesh[0], mesh[1], device=kw.get("device", "cuda"),
                         n_hosts=comm.size)
    model = MultiHostGoICP(pct, pcs, comm, lut_resolution=lut_resolution,
                           mse_threshold=mse_threshold, engine=engine,
                           mesh=mesh, **kw)
    R, t = model.run()
    return model, R, t
