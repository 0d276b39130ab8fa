"""register_p90_s (s): the 90th percentile of the latency of every request
of the window."""

from portbench import readers


def read(ctx):
    return readers.percentile(ctx["latencies"], 90)
