"""Arithmetic shared by the metric readers (`metrics/<name>.py`).

Every reader takes the run's context (`run.run_cell`): setup_s, window_s,
requests, pairs, latencies, certified (answers certified), counters (the
entry's counters) and spans_s (seconds per span, traced runs) over the
later_requests / later_pairs after the profiled ones (all of the window's
in an untraced run), and profile (the traced requests' reduced profile:
busy_s, window_s, launches, kernel_s, requests, pairs, nn_calls; None in
an untraced run).  A reader returns a number, or None where it finds
nothing to read.
"""

from __future__ import annotations

import statistics

from . import roofline
from .trace import kernel_base

# Kernel labels (trace.kernel_label) of the program's kernels.
NN_KERNELS = ("nn_kernel", "fill_big_kernel")


def per(ctx, total, unit: str, scale: float = 1e3):
    """total over the window's requests or pairs (`unit`), times scale."""
    n = ctx[unit]
    return None if total is None or not n else scale * total / n


def span_ms(ctx, name: str):
    return per(ctx, ctx["spans_s"].get(name), "later_requests")


def counter_ms(ctx, name: str, unit: str):
    """A counter's ms per later request or pair (`unit` "requests" or
    "pairs")."""
    return per(ctx, ctx["counters"].get(name), "later_" + unit)


def percentile(values, q: int):
    """The q-th percentile (linear interpolation between order statistics,
    statistics.quantiles' inclusive method)."""
    if len(values) < 2:
        return values[0] if values else None
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def kernel_s(profile, labels) -> float:
    return sum(s for name, s in profile["kernel_s"].items()
               if kernel_base(name) in labels)


def nn_roofline(ctx):
    """The NN kernels' share of their exhaustive-scan bound, in %."""
    p = ctx["profile"]
    if p is None or not p["nn_calls"]:
        return None
    busy = kernel_s(p, NN_KERNELS)
    return 100.0 * roofline.nn_bound_s(p["nn_calls"]) / busy if busy else None


def device_idle_pct(ctx):
    p = ctx["profile"]
    if p is None or not p["window_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def launches_per_pair(ctx):
    p = ctx["profile"]
    return None if p is None else per(p, p["launches"], "pairs", 1.0)
