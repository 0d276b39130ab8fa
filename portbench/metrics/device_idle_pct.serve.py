"""device_idle_pct.serve (%): the share of the traced requests' window
without device activity."""

from portbench import readers


def read(ctx):
    return readers.device_idle_pct(ctx)
