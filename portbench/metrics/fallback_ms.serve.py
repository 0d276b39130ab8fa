"""fallback_ms.serve (ms/pair): the BnB fallbacks
(ServiceStats.fallback_seconds) per pair."""

from portbench import readers


def read(ctx):
    return readers.counter_ms(ctx, "fallback_seconds", "pairs")
