"""seed_ms.register (ms): the serving seeding (ServiceStats.seed_seconds)
per request."""

from portbench import readers


def read(ctx):
    return readers.counter_ms(ctx, "seed_seconds", "requests")
