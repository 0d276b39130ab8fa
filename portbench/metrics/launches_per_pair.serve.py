"""launches_per_pair.serve (launches): CUDA kernel launches of the traced
requests per pair."""

from portbench import readers


def read(ctx):
    return readers.launches_per_pair(ctx)
