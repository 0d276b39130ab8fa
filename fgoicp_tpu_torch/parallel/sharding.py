"""The (cubes, points) device mesh of sharded Go-ICP, over torch.distributed.

Counterpart of `fgoicp_tpu/parallel/sharding.py`.  The JAX package names
two mesh axes and runs each sharded function as one `shard_map` program:

* ``cubes``  -- node parallelism: rotation groups (inner R^3 searches, ICP
  lanes, serving pairs) shard over it; the only traffic is the lockstep
  loop vote and the gathers of per-group results;
* ``points`` -- the source points of bound evaluation (and the target rows
  of ICP) shard over it, with per-point partial sums reduced by a psum.

Here the mesh is SPMD over processes: one process per mesh position, rank
r at (c, p) = divmod(r, n_points), as JAX's
``np.asarray(devices).reshape(n_cubes, n_points)``.  Every rank runs the
same host code in lockstep, holds the full clouds and slices its shard when
a sharded function is called; every host decision reads only replicated
values (the outputs of collectives), and every rank calls the same
collectives in the same order, or the mesh deadlocks.

An `Axis` is one named axis of a rank's position: the process group of the
ranks that differ from it along that axis only, with the collectives the
ops call where JAX names an axis (`psum`, `pmin`, `pmax`, `all_gather`).
Each collective is one all-gather, reduced on the rank in axis order, so
every rank of a group holds the same bits (a psum of two shards is a + b,
as JAX's).  A size-1 axis makes no call at all, so a 1 x 1 mesh runs the
single-device path bit for bit.  Each axis counts its collectives, the
bytes they gather and the host copies they stage (`collectives`, `bytes`,
`host_copies`), as the kernel wrappers count `launches`.

Hosts on meshes: `make_mesh(..., n_hosts=H)` cuts a world of H x n_cubes x
n_points ranks into H meshes, one a host of the multi-host layer
(parallel/distributed.py): rank r on host h = r // K at mesh position
k = r % K, K = n_cubes x n_points, and (c, p) = divmod(k, n_points) as
above.  `Mesh.rank` is the position k within its own mesh (k = 0 writes
that host's checkpoints), `Mesh.world_rank` the rank in the world, and
`Mesh.host` the host h.

Backend: `make_mesh(..., backend=None)` takes NCCL when every rank owns a
card of its own, else gloo (ranks sharing a card, or the CPU); the choice
is logged and never retried under the other backend.  Gloo gathers CUDA
tensors only through the host, so the axis stages them there explicitly
(one copy to the host, one back, counted); the compute stays on the card.
A collective that times out or loses a peer raises RuntimeError.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

from ..utils import logging as log
from ..utils import trace

CUBES_AXIS = "cubes"
POINTS_AXIS = "points"
# Default bound of one collective's wait (and of the rendezvous), seconds.
DEFAULT_TIMEOUT_S = 600.0

_LOST_PEER = (
    "mesh collective on axis {name!r} timed out or lost a peer: a rank is "
    "likely dead, hung, or running host code that diverged from the other "
    "ranks (every host decision must read only replicated values)")


class Axis:
    """One named mesh axis of this rank: `size` positions, this rank at
    `index`, `group` the process group along it (None for size 1), and
    `timeout` the bound of one collective's wait in seconds (None: the
    group's own)."""

    def __init__(self, name: str, size: int = 1, index: int = 0, group=None,
                 stage: bool = False, timeout: Optional[float] = None):
        self.name, self.size, self.index = name, size, index
        self.group = group
        self._stage = stage
        self.timeout = timeout
        self.collectives = 0
        self.bytes = 0
        self.host_copies = 0

    def __repr__(self):
        return f"Axis({self.name!r}, size={self.size}, index={self.index})"

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This position's block of the leading axis of x (its length a
        multiple of size), as shard_map hands a P(axis) input to the body."""
        n = x.shape[0] // self.size
        return x[self.index * n:(self.index + 1) * n]

    def _gather(self, x: torch.Tensor) -> list:
        """[x of every position, in axis order] over the group."""
        import torch.distributed as dist
        dev, dtype = x.device, x.dtype
        wire = x.to(torch.uint8) if dtype == torch.bool else x
        wire = wire.contiguous()
        if self._stage and wire.is_cuda:
            wire = wire.cpu()
            self.host_copies += 1
        outs = [torch.empty_like(wire) for _ in range(self.size)]
        try:
            work = dist.all_gather(outs, wire, group=self.group,
                                   async_op=True)
            if self.timeout is None:
                work.wait()
            else:
                work.wait(timeout=datetime.timedelta(seconds=self.timeout))
        except RuntimeError as err:
            raise RuntimeError(
                f"{_LOST_PEER.format(name=self.name)} ({err})") from err
        self.collectives += 1
        self.bytes += wire.numel() * wire.element_size() * self.size
        if outs[0].device != dev:
            outs = list(torch.stack(outs).to(dev).unbind(0))
            self.host_copies += 1
        if dtype == torch.bool:
            outs = [o.to(torch.bool) for o in outs]
        return outs

    def all_gather(self, x: torch.Tensor, dim: int = 0,
                   tiled: bool = True) -> torch.Tensor:
        """jax.lax.all_gather(x, axis, axis=dim, tiled=tiled)."""
        if self.size == 1:
            return x if tiled else x.unsqueeze(dim)
        parts = self._gather(x)
        return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)

    def _reduce(self, x: torch.Tensor, op):
        if self.size == 1:
            return x
        parts = self._gather(x)
        out = parts[0]
        for part in parts[1:]:
            out = op(out, part)
        return out

    def psum(self, x):
        """Sum over the axis, added in axis order."""
        return self._reduce(x, torch.add)

    def pmin(self, x):
        return self._reduce(x, torch.minimum)

    def pmax(self, x):
        return self._reduce(x, torch.maximum)


def sharded(axis: Optional[Axis]) -> bool:
    """True when `axis` holds more than one position (a collective runs)."""
    return axis is not None and axis.size > 1


def any_live(active: torch.Tensor, axes) -> bool:
    """Whether any group of any rank is live: the lockstep vote of the
    sharded BnB loops, the live count psum'd over each sharded axis of
    `axes` in turn (JAX's psum over a tuple of axis names).  Without one,
    the local test, and no call.  One host read (`trace.to_host`)."""
    axes = [a for a in axes if sharded(a)]
    if not axes:
        return bool(trace.to_host(torch.any(active)))
    n = torch.sum(active)
    for axis in axes:
        n = axis.psum(n)
    return int(trace.to_host(n)) > 0


class Mesh:
    """This rank's view of an (n_cubes, n_points) mesh: its `cubes` and
    `points` axes, its `device`, its `rank` (the position within this
    mesh), its `world_rank` in the torch.distributed world and the `host`
    whose mesh it is (0 unless the world holds several hosts' meshes)."""

    def __init__(self, cubes: Axis, points: Axis, device: torch.device,
                 rank: int = 0, world_rank: Optional[int] = None,
                 host: int = 0):
        self.cubes, self.points = cubes, points
        self.device = device
        self.rank = rank
        self.world_rank = rank if world_rank is None else world_rank
        self.host = host

    def axis(self, name: str) -> Axis:
        return {CUBES_AXIS: self.cubes, POINTS_AXIS: self.points}[name]

    @property
    def size(self) -> int:
        return self.cubes.size * self.points.size

    def counters(self) -> dict:
        """Collectives, gathered bytes and host copies, summed over both
        axes."""
        axes = (self.cubes, self.points)
        return dict(collectives=sum(a.collectives for a in axes),
                    bytes=sum(a.bytes for a in axes),
                    host_copies=sum(a.host_copies for a in axes))

    def reset_counters(self) -> None:
        for a in (self.cubes, self.points):
            a.collectives = a.bytes = a.host_copies = 0


def _local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def _mesh_device(device, rank: int = 0) -> torch.device:
    """cuda:(local rank % card count) for "cuda" (raises without a card), a
    given index or the CPU as asked."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device(
                "cuda", _local_rank(rank) % torch.cuda.device_count())
    elif dev.type != "cpu":
        raise ValueError(f"Unsupported device: {device!r}")
    return dev


def _default_backend(world: int, device: torch.device) -> str:
    """NCCL when every rank of this host owns a card of its own, else gloo
    (ranks sharing a card, or the CPU)."""
    if device.type != "cuda":
        return "gloo"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def make_mesh(n_cubes: Optional[int] = None, n_points: int = 1,
              device="cuda", backend: Optional[str] = None,
              timeout: Optional[float] = None, n_hosts: int = 1) -> Mesh:
    """This rank's (cubes, points) mesh over the torch.distributed world,
    or over its host's block of it when the world holds n_hosts meshes.

    With n_cubes=None every rank of a host not on the points axis goes to
    the cubes axis.  The world is the default process group's; when none is
    initialized and WORLD_SIZE says more than one rank (torchrun), this
    joins it through `distributed.initialize` (env://); otherwise the world
    is this one process.  Raises ValueError when the world does not hold
    n_hosts x n_cubes x n_points ranks, as JAX's make_mesh does for
    devices.  Every rank must call this with the same arguments: it creates
    every axis group of every host in the same order on every rank (a rank
    that skipped one would deadlock the world at `new_group`)."""
    import torch.distributed as dist
    timeout = DEFAULT_TIMEOUT_S if timeout is None else timeout
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world = int(os.environ.get("WORLD_SIZE", 1))
        rank = int(os.environ.get("RANK", 0))
    if n_hosts < 1 or world % n_hosts:
        raise ValueError(f"n_hosts={n_hosts} must divide {world} ranks")
    per_host = world // n_hosts
    if n_points < 1 or per_host % n_points:
        raise ValueError(f"mesh_points={n_points} must divide {per_host} "
                         f"ranks a host")
    if n_cubes is None:
        n_cubes = per_host // n_points
    if n_cubes * n_points != per_host:
        hosts = f"{n_hosts} hosts x " if n_hosts > 1 else ""
        raise ValueError(f"mesh {hosts}{n_cubes}x{n_points} != {world} ranks "
                         f"of the torch.distributed world")
    dev = _mesh_device(device, rank)
    host, k = divmod(rank, per_host)
    if world > 1 and not dist.is_initialized():
        from .distributed import initialize
        backend = backend or _default_backend(world, dev)
        initialize(backend=backend, timeout=timeout)
    elif world > 1 and backend is None:
        backend = dist.get_backend()
    if per_host == 1:
        return Mesh(Axis(CUBES_AXIS), Axis(POINTS_AXIS), dev, 0, rank, host)
    if backend == "nccl" and dev.type == "cuda":
        torch.cuda.set_device(dev)
    log.info(f"mesh {n_cubes}x{n_points} of host {host}: rank {rank} on "
             f"{dev}, backend {backend}")
    kw = dict(backend=backend, timeout=datetime.timedelta(seconds=timeout))
    # Every rank creates every group of every host, in the same order.
    rows, cols = {}, {}
    for h in range(n_hosts):
        first = h * per_host
        for ci in range(n_cubes):
            rows[h, ci] = dist.new_group(
                [first + ci * n_points + pi for pi in range(n_points)],
                **kw) if n_points > 1 else None
        for pi in range(n_points):
            cols[h, pi] = dist.new_group(
                [first + ci * n_points + pi for ci in range(n_cubes)],
                **kw) if n_cubes > 1 else None
    c, p = divmod(k, n_points)
    stage = backend == "gloo" and dev.type == "cuda"
    return Mesh(Axis(CUBES_AXIS, n_cubes, c, cols[host, p], stage, timeout),
                Axis(POINTS_AXIS, n_points, p, rows[host, c], stage, timeout),
                dev, k, rank, host)


def spawn_ranks(entry: str, argv, ranks: int) -> int:
    """Run `entry(argv)` ("module:function", returning an exit code) in
    `ranks` spawned processes that join one process group over env:// on a
    free localhost port (RANK, LOCAL_RANK, WORLD_SIZE, ... set as torchrun
    sets them).  Returns the first nonzero exit code of a rank, else 0."""
    import socket

    import torch.multiprocessing as mp
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    try:
        mp.start_processes(_spawned_rank, args=(entry, list(argv), ranks,
                                                port),
                           nprocs=ranks, start_method="spawn")
    except mp.ProcessExitedException as err:
        return err.exit_code or 1
    except mp.ProcessRaisedException as err:
        log.error(f"a rank of the mesh failed:\n{err}")
        return 1
    return 0


def _spawned_rank(rank: int, entry: str, argv, ranks: int,
                  port: int) -> None:
    """One process of `spawn_ranks`; exits with the entry's nonzero code.
    The entry is imported by name: a `__main__` module cannot be pickled
    into a spawned process."""
    import importlib
    import sys

    import torch.distributed as dist
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(ranks), LOCAL_WORLD_SIZE=str(ranks),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    module, name = entry.split(":")
    try:
        rc = getattr(importlib.import_module(module), name)(argv)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if rc:
        sys.exit(rc)


def single_device_mesh(device="cuda") -> Mesh:
    """A 1 x 1 mesh on one device: no process group, no collective."""
    dev = device if isinstance(device, torch.device) else _mesh_device(device)
    return Mesh(Axis(CUBES_AXIS), Axis(POINTS_AXIS), dev)


def shard_groups(mesh: Mesh, tensors):
    """This rank's cube-shard of per-group tensors (leading axis G, a
    multiple of the cubes axis size)."""
    return [mesh.cubes.shard(t) for t in tensors]


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
