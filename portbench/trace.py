"""The traced run's instruments: synchronized spans around the program's
calls, a recorder of the NN kernels' shapes, and the reduction of a
torch.profiler trace to device time, launches and idle gaps.

Spans (a copy of the pattern of the port's `scripts/profile_phases.timed`):
each wrapped call synchronizes the device before and after, so its device
work is billed to it; nested spans of the same name count once.  That adds
synchronizations, so spans are installed in traced runs only.
"""

from __future__ import annotations

import collections
import time

import numpy as np

LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
WINDOW = "portbench.window"
SPAN_PREFIX = "portbench."


class Spans:
    """Seconds per span name, from synchronized wrappers around methods.

    `install(owner, attr, name)` replaces owner.attr by a wrapper (owner a
    class or a module); `restore()` puts every original back."""

    def __init__(self, sync, label):
        self.sync = sync
        self.label = label   # a context naming the span in the profile
        self.seconds = collections.defaultdict(float)
        self._open = collections.Counter()
        self._saved = []

    def install(self, owner, attr, name):
        fn = getattr(owner, attr)
        self._saved.append((owner, attr, fn))
        self.seconds[name] += 0.0

        def wrapped(*a, **kw):
            if self._open[name]:
                return fn(*a, **kw)
            self.sync()
            t0 = time.perf_counter()
            self._open[name] += 1
            try:
                with self.label(SPAN_PREFIX + name):
                    out = fn(*a, **kw)
                    self.sync()
            finally:
                self._open[name] -= 1
            self.seconds[name] += time.perf_counter() - t0
            return out

        setattr(owner, attr, wrapped)

    def restore(self):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()


class NNCalls:
    """Records (kind, queries, targets) of every call of the NN kernels'
    wrappers of `module` while installed.  The program's wrappers count
    their own launches through their module-level names, so the stand-ins
    carry those counters while installed and hand them back."""

    KINDS = ("nn_argmin", "nn_min")
    COUNTERS = ("launches", "shapes")

    def __init__(self, module):
        self.module = module
        self.calls = []
        self._saved = {}

    def install(self):
        for kind in self.KINDS:
            fn = getattr(self.module, kind)
            self._saved[kind] = fn

            def wrapped(queries, points, _fn=fn, _kind=kind):
                self.calls.append((_kind, int(queries.shape[0]),
                                   int(points.shape[0])))
                return _fn(queries, points)

            for c in self.COUNTERS:
                if hasattr(fn, c):
                    setattr(wrapped, c, getattr(fn, c))
            setattr(self.module, kind, wrapped)

    def restore(self):
        for kind, fn in self._saved.items():
            wrapped = getattr(self.module, kind)
            for c in self.COUNTERS:
                if hasattr(wrapped, c):
                    setattr(fn, c, getattr(wrapped, c))
            setattr(self.module, kind, fn)
        self._saved.clear()


def events(prof):
    """[(name, on_device, start_ns, end_ns)] of a finished profile."""
    return [(ev.name(), str(ev.device_type()).endswith("CUDA"),
             ev.start_ns(), ev.start_ns() + ev.duration_ns())
            for ev in prof.profiler.kineto_results.events()]


def kernel_label(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    argument list: "nn_kernel<true, false>"."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0]


def kernel_base(label: str) -> str:
    """A label without namespaces and template arguments: "nn_kernel"."""
    return label.split("<")[0].split("::")[-1]


def _union(intervals):
    """Merged [(a, b)] of sorted intervals."""
    merged = []
    for a, b in intervals:
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged


def _innermost(starts, ends, names, at):
    """The name of the latest-starting event that contains time `at`."""
    inside = np.nonzero((starts <= at) & (ends >= at))[0]
    if not len(inside):
        return None
    return names[inside[np.argmax(starts[inside])]]


def reduce(evs, top: int = 10) -> dict:
    """The traced window's device time and launches from events(): busy_s
    (the union of device activity inside the window), window_s, launches
    (the CUDA runtime's kernel launches), kernel_s (device seconds by
    kernel label), device_ops (the `top` labels by time) and idle_gaps (the
    `top` longest stretches without device activity, each named by the
    innermost benchmark span and the innermost host op running at its
    middle)."""
    win = [(a, b) for n, dev, a, b in evs if n == WINDOW and not dev]
    if not win:
        raise ValueError(f"the trace holds no {WINDOW!r} span")
    w0, w1 = win[0]
    # Device activity: kernels, copies and sets; the device-side copies of
    # the benchmark's own spans (user annotations) are not activity.
    dev = [(n, max(a, w0), min(b, w1)) for n, d, a, b in evs
           if d and b > w0 and a < w1 and not n.startswith(SPAN_PREFIX)]
    busy = _union(sorted((a, b) for _, a, b in dev))
    kernel_s = collections.Counter()
    for n, a, b in dev:
        kernel_s[kernel_label(n)] += (b - a) / 1e9
    host = [(n, a, b) for n, d, a, b in evs
            if not d and n != WINDOW and b > w0 and a < w1]
    launches = sum(n in LAUNCH_KEYS for n, _, _ in host)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top]
    spans = [h for h in host if h[0].startswith(SPAN_PREFIX)]
    ops = [h for h in host if not h[0].startswith(SPAN_PREFIX)]
    arrays = lambda hs: (np.array([h[1] for h in hs], np.int64),
                         np.array([h[2] for h in hs], np.int64),
                         [h[0] for h in hs])
    span_a, op_a = arrays(spans), arrays(ops)
    idle = []
    for length, a, b in gaps:
        mid = (a + b) // 2
        span = _innermost(*span_a, mid) if spans else None
        op = _innermost(*op_a, mid) if ops else None
        label = " / ".join(x for x in (span and span[len(SPAN_PREFIX):],
                                       op or "host") if x)
        idle.append([label, length / 1e9])
    return {"busy_s": sum(b - a for a, b in busy) / 1e9,
            "window_s": (w1 - w0) / 1e9, "launches": launches,
            "kernel_s": dict(kernel_s),
            "device_ops": [[k, v] for k, v in kernel_s.most_common(top)],
            "idle_gaps": idle}
