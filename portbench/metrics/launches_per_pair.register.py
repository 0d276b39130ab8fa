"""launches_per_pair.register (launches): CUDA kernel launches of the traced
requests per pair."""

from portbench import readers


def read(ctx):
    return readers.launches_per_pair(ctx)
