"""seed_ms.serve (ms/pair): the serving seeding (ServiceStats.seed_seconds)
per pair."""

from portbench import readers


def read(ctx):
    return readers.counter_ms(ctx, "seed_seconds", "pairs")
