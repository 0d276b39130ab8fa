"""Per-request host spans and counters, host reads, and profiler ranges on
demand: the port's one tracer.

**Requests.**  The public entries open one request record each:
`models.goicp.register` and `GoICP.run` called on its own ("register"),
and `RegistrationService.register` ("serve").  An entry reached inside an
open request joins it: a `register()` call's construction and run, and a
serving batch's fallbacks (their construction and run), belong to the one
request.  A record holds its id and kind, its host seconds, per span name
the host seconds (total, and self: the total less its child spans), the
counts below, the host reads and their waits, and the deltas over the
request of the counters the program already keeps: every kernel wrapper's
`launches` (`ops/cuda_nn`, `ops/cuda_bounds`, `ops/cuda_minplus`,
`ops/cuda_icp`, `ops/cuda_fps`, `ops/cuda_pool`, read through their
modules, never duplicated; LAUNCH_COUNTERS is the port's one list of its
kernel wrappers) and, where the request runs on a
mesh, the mesh axes' `collectives`, `bytes` and `host_copies`.
`requests()` gives the newest `RING` records, oldest first.  The open
request is the calling thread's, so thread hosts keep their own.

**Spans** (`spanned(name)` on a function): host time from
`time.perf_counter_ns()`, never synchronized: the program is paced by the
host, whose time is what they measure, and the only waits are the reads,
which time themselves.  Outside a request a span costs one attribute read.
Span names: "construct" (`GoICP.__init__`), "construct.fps" (every
`ops/coreset.farthest_point_sample`), "icp" (`models/icp.icp_batched`),
"icp.rescore" (`exact_sse_batched`), "bnb" (`GoICP._branch_and_bound_so3`,
the outer SO(3) search in host and device modes), "inner_bnb"
(`GoICP._evaluate_children`), "seed" and "fallback"
(`RegistrationService._seed_call`, `._fallback`); the request's own span
is named by its kind.

**Counts** (`count(name, n)`, once a call, never once an iteration):
"fps_steps" (an FPS call's k - 1 steps), "icp_iterations" (an
`icp_batched` call's lockstep iterations), "icp_lanes" (its lanes),
"inner_nodes" (the inner-BnB bound evaluations, the growth of
`GoICPStats.translation_nodes`), "outer_steps", "rotation_children",
"rotation_pruned" and "icp_triggered" (the growth of those `GoICPStats`
fields), "pool_steps" (a pooled inner BnB's steps,
`ops/pool_frontier.bnb_r3_pooled`), "bound_bytes" (the argument bytes of
each bound-kernel launch, `ops/cuda_bounds`), and "host_reads".

**Device counts** (`device_counts(device)`): the bound kernels add the
(point, proxy) pairs they evaluate and the (point, box) tests they make to
an int64 [2] tensor of the open request on the device, zeroed by a copy
from pinned host memory (no kernel).  It comes back to the host on a read
the request already makes: a `to_host` after a launch first queues an
asynchronous copy of it into the pinned memory, which the read's own wait
covers.  At the end of the request it is "bound_pairs" and
"bound_box_tests"; only where no read followed the last launch does the
end make one read of its own.

**Host reads** (`to_host(*tensors)`): every synchronizing read of the hot
path copies through it.  Each tensor is one read (its own copy to the
host) counted under "host_reads", and the blocking call is timed into
`host_wait_s`, both also kept under the innermost open span.

**Ranges** (`enable()`, or the CLI's --profile): each span, each request
and each read also opens a `torch.profiler.record_function` range, so a
profile shows them in the kineto timeline beside the kernels, on the
profiler's clock.  A range is named `range_name(span, request id, parent
span)`: "fgoicp.icp#12<seed" is an ICP of request 12 inside its seeding,
"fgoicp.read#12<icp" a read inside it, "fgoicp.serve#12" the request
itself.  The profiler keeps them in memory with its events and writes them
only when its trace is exported.  Off by default: a range's device-side
annotation would read as device activity to a tool that counts every
device event.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import sys
import threading
import time
from typing import Optional

# Records kept, the newest first: a record takes ~2-4 KB of host memory, so
# the ring holds at most 16-32 MB.  A reader of `requests()` over a longer
# stretch than RING requests finds its oldest ones gone.
RING = 8192
PREFIX = "fgoicp."
# (module, kernel wrappers) whose `launches` a request reads.
_PKG = __name__.rsplit(".", 2)[0]
LAUNCH_COUNTERS = (
    (f"{_PKG}.ops.cuda_nn", ("nn_argmin", "nn_min")),
    (f"{_PKG}.ops.cuda_bounds", ("fused_bounds_lanes",
                                 "fused_bounds_lanes_trimmed",
                                 "fused_bounds")),
    (f"{_PKG}.ops.cuda_minplus", ("minplus_1d",)),
    (f"{_PKG}.ops.cuda_icp", ("icp_align", "icp_commit")),
    (f"{_PKG}.ops.cuda_fps", ("farthest_point_sample",)),
    (f"{_PKG}.ops.cuda_pool", ("pool_commit",)),
)

_ring: collections.deque = collections.deque(maxlen=RING)
_ids = itertools.count(1)
_local = threading.local()
_ranges = False


@dataclasses.dataclass
class Span:
    """One span name's totals over a request."""
    calls: int = 0
    total_s: float = 0.0
    self_s: float = 0.0       # total less its child spans
    host_reads: int = 0       # the reads made in its self time
    host_wait_s: float = 0.0
    under: dict = dataclasses.field(default_factory=dict)  # parent -> s


@dataclasses.dataclass
class Request:
    id: int
    kind: str                 # "register" or "serve"
    seconds: float = 0.0
    spans: dict = dataclasses.field(default_factory=dict)   # name -> Span
    counts: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    host_wait_s: float = 0.0
    launches: dict = dataclasses.field(default_factory=dict)
    mesh: dict = dataclasses.field(default_factory=dict)

    @property
    def host_reads(self) -> int:
        return self.counts["host_reads"]

    def span_s(self, name: str) -> float:
        """The total seconds of span `name` (0 where it never opened)."""
        span = self.spans.get(name)
        return 0.0 if span is None else span.total_s


class _DeviceCounts:
    """A request's int64 [2] counter on one device, its pinned host copy,
    and whether a launch may have changed it since its last copy."""

    __slots__ = ("dev", "host", "stale")

    def __init__(self, device):
        import torch
        self.host = torch.zeros(2, dtype=torch.int64,
                                pin_memory=device.type == "cuda")
        self.dev = torch.empty(2, dtype=torch.int64, device=device)
        self.dev.copy_(self.host, non_blocking=True)
        self.stale = False

    def stage(self):
        """Queue the copy to the host; the next synchronizing read of the
        device's stream completes it."""
        self.host.copy_(self.dev, non_blocking=True)
        self.stale = False


class _Open:
    """The calling thread's open request: its record, the stack of open
    frames [Span, name, start ns, child ns, range], the launch counters at
    its start, the mesh it watches and its device counts by device."""

    __slots__ = ("rec", "stack", "launches0", "mesh", "mesh0", "devcounts")

    def __init__(self, rec: Request):
        self.rec = rec
        self.stack = []
        self.launches0 = launch_counts()
        self.mesh = self.mesh0 = None
        self.devcounts = {}


def now() -> float:
    """The tracer's monotonic clock, in seconds."""
    return time.perf_counter()


def requests() -> list:
    """The newest request records (at most RING), oldest first."""
    return list(_ring)


def enable(on: bool = True) -> None:
    """Turn the profiler ranges on (or off)."""
    global _ranges
    _ranges = bool(on)


def enabled() -> bool:
    return _ranges


def range_name(span: str, rid: int, parent: Optional[str] = None) -> str:
    """"fgoicp.<span>#<request id>[<<parent span>]"."""
    return f"{PREFIX}{span}#{rid}" + ("" if parent is None else f"<{parent}")


def parse_range(name: str):
    """(span, request id, parent span or None) of a range name."""
    head, _, parent = name[len(PREFIX):].partition("<")
    span, _, rid = head.rpartition("#")
    return span, int(rid), parent or None


def launch_counts() -> dict:
    """Every kernel wrapper's cumulative `launches` (0 for a module not
    loaded yet)."""
    out = {}
    for module, names in LAUNCH_COUNTERS:
        mod = sys.modules.get(module)
        for name in names:
            out[name] = getattr(getattr(mod, name, None), "launches", 0)
    return out


def _range(span: str, op: _Open):
    from torch.profiler import record_function
    parent = op.stack[-1][1] if op.stack else None
    rf = record_function(range_name(span, op.rec.id, parent))
    rf.__enter__()
    return rf


def _enter(op: _Open, name: str) -> None:
    span = op.rec.spans.get(name)
    if span is None:
        span = op.rec.spans[name] = Span()
    rf = _range(name, op) if _ranges else None
    op.stack.append([span, name, time.perf_counter_ns(), 0, rf])


def _exit(op: _Open) -> int:
    span, name, t0, child, rf = op.stack.pop()
    dt = time.perf_counter_ns() - t0
    if rf is not None:
        rf.__exit__(None, None, None)
    span.calls += 1
    span.total_s += dt * 1e-9
    span.self_s += (dt - child) * 1e-9
    if op.stack:
        parent = op.stack[-1]
        parent[3] += dt
        span.under[parent[1]] = span.under.get(parent[1], 0.0) + dt * 1e-9
    return dt


def entry(kind: str):
    """Decorator of a public entry: the call opens a request record of
    `kind`, or joins the calling thread's open request."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if getattr(_local, "op", None) is not None:
                return fn(*args, **kwargs)
            op = _local.op = _Open(Request(next(_ids), kind))
            _enter(op, kind)
            try:
                return fn(*args, **kwargs)
            finally:
                _read_device_counts(op)
                _local.op = None
                rec = op.rec
                rec.seconds = _exit(op) * 1e-9
                after = launch_counts()
                rec.launches = {k: v - op.launches0.get(k, 0)
                                for k, v in after.items()}
                if op.mesh is not None:
                    rec.mesh = {k: v - op.mesh0[k]
                                for k, v in op.mesh.counters().items()}
                _ring.append(rec)
        return run
    return wrap


def spanned(name: str):
    """Decorator: each call inside a request is a span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            op = getattr(_local, "op", None)
            if op is None:
                return fn(*args, **kwargs)
            _enter(op, name)
            try:
                return fn(*args, **kwargs)
            finally:
                _exit(op)
        return run
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add n to the open request's count `name` (no request: nothing)."""
    op = getattr(_local, "op", None)
    if op is not None:
        op.rec.counts[name] += n


def watch_mesh(mesh) -> None:
    """The open request reads `mesh`'s counters from now to its end (the
    first mesh it is given; None is no mesh)."""
    op = getattr(_local, "op", None)
    if op is not None and mesh is not None and op.mesh is None:
        op.mesh, op.mesh0 = mesh, mesh.counters()


def device_counts(device):
    """The open request's int64 [2] counter on CUDA `device`, for a kernel
    launch that adds to it (marked as changed); None outside a request."""
    op = getattr(_local, "op", None)
    if op is None:
        return None
    c = op.devcounts.get(device)
    if c is None:
        c = op.devcounts[device] = _DeviceCounts(device)
    c.stale = True
    return c.dev


def _read_device_counts(op: _Open) -> None:
    """The request's device counts into its counts "bound_pairs" and
    "bound_box_tests" (a read of its own only for a counter that no read
    has covered since its last launch)."""
    for c in op.devcounts.values():
        # A stale counter's read stages its copy and waits for it.
        pairs, tests = (to_host(c.dev) if c.stale else c.host).tolist()
        op.rec.counts["bound_pairs"] += pairs
        op.rec.counts["bound_box_tests"] += tests


def to_host(*tensors):
    """numpy copies of `tensors` (one array for one tensor, else a tuple):
    the hot path's synchronizing reads.  Inside a request each tensor
    counts one host read, and the blocking call's seconds add to
    host_wait_s, of the request and of its innermost open span.  A device
    counter changed since its last copy rides along on the read of a tensor
    on its device (module doc)."""
    op = getattr(_local, "op", None)
    if op is not None and op.devcounts:
        for t in tensors:
            c = op.devcounts.get(t.device)
            if c is not None and c.stale:
                c.stage()
    rf = _range("read", op) if op is not None and _ranges else None
    t0 = time.perf_counter_ns()
    out = tuple(t.cpu().numpy() for t in tensors)
    if op is not None:
        wait = (time.perf_counter_ns() - t0) * 1e-9
        if rf is not None:
            rf.__exit__(None, None, None)
        span = op.stack[-1][0]
        span.host_reads += len(tensors)
        span.host_wait_s += wait
        op.rec.counts["host_reads"] += len(tensors)
        op.rec.host_wait_s += wait
    return out[0] if len(out) == 1 else out


def summary(rec: Request) -> str:
    """One request on a few lines, for the log."""
    spans = ", ".join(
        f"{name} {s.total_s:.4f} s (self {s.self_s:.4f}, {s.calls} calls)"
        for name, s in rec.spans.items())
    counts = ", ".join(f"{k} {v}" for k, v in sorted(rec.counts.items()))
    launches = {k: v for k, v in rec.launches.items() if v}
    text = (f"Request {rec.id} ({rec.kind}): {rec.seconds:.4f} s; "
            f"host_reads {rec.host_reads}, host_wait_s "
            f"{rec.host_wait_s:.4f}\n\tspans: {spans}\n\tcounts: {counts}"
            f"\n\tlaunches: {launches}")
    if "icp_iterations" in rec.counts:
        text += (f"\n\ticp: icp_iterations {rec.counts['icp_iterations']}, "
                 f"on the kernels {rec.launches.get('icp_commit', 0)} "
                 f"(icp_commit launches)")
    if "outer_steps" in rec.counts:
        text += (f"\n\tsearch: outer_steps {rec.counts['outer_steps']}, "
                 f"pool_steps {rec.counts['pool_steps']}, inner_nodes "
                 f"{rec.counts['inner_nodes']}")
    if rec.mesh:
        text += f"\n\tmesh: {rec.mesh}"
    return text
