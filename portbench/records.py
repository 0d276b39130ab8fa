"""The program's own request records, for the readers of the metrics that
the program times and counts itself (`program_span`, `program_counter`).

Like the entries, and unlike the rest of the yardstick, this module reaches
the program: it reads `fgoicp_tpu_torch.utils.trace.requests()`, the ring of
the program's request records (each with its span seconds, counts, host
reads and host wait).  The run calls nothing in the program after the
window, so the ring's last `later_requests` records are the window's
requests after the profiled ones.  A reader finds nothing, and returns
None, in an untraced run (whose readers are the end-to-end ones), where
the program keeps no records (a checkout without the tracer), or where the
ring holds fewer records than that.
"""

from __future__ import annotations


def later(ctx):
    """The records of the window's requests after the profiled ones, or
    None."""
    n = ctx["later_requests"]
    if ctx["profile"] is None or not n:
        return None
    try:
        from fgoicp_tpu_torch.utils import trace
    except ImportError:
        return None
    recs = trace.requests()
    return recs[-n:] if len(recs) >= n else None


def span_ms(ctx, name: str):
    """Span `name`'s host ms per later request; None where no record
    holds it."""
    recs = later(ctx)
    if recs is None or not any(name in r.spans for r in recs):
        return None
    return 1e3 * sum(r.span_s(name) for r in recs) / len(recs)


def icp_iter_ms(ctx):
    """The "icp" span's host ms over its lockstep iterations."""
    recs = later(ctx)
    iters = None if recs is None else sum(
        r.counts["icp_iterations"] for r in recs)
    if not iters:
        return None
    return 1e3 * sum(r.span_s("icp") for r in recs) / iters


def per(ctx, value, unit: str, scale: float = 1.0):
    """sum(value(record)) over the later records, per later request
    (`unit` "requests") or pair ("pairs"), times scale."""
    recs = later(ctx)
    n = ctx["later_" + unit]
    if recs is None or not n:
        return None
    return scale * sum(value(r) for r in recs) / n


def host_wait_ms(ctx, unit: str):
    return per(ctx, lambda r: r.host_wait_s, unit, 1e3)


def host_reads(ctx, unit: str):
    return per(ctx, lambda r: r.host_reads, unit)
