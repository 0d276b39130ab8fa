"""pool_step_ms.register (ms): the program's "inner_bnb" span (every
inner-BnB call) over the pooled steps it counts ("pool_steps"), host ms a
step."""

from portbench import records


def read(ctx):
    recs = records.later(ctx)
    steps = None if recs is None else sum(
        r.counts["pool_steps"] for r in recs)
    if not steps:
        return None
    return 1e3 * sum(r.span_s("inner_bnb") for r in recs) / steps
