"""host_wait_ms.serve (ms/pair): the program's host_wait_s, the host's time
blocked in its synchronizing reads (waiting for the device), per pair."""

from portbench import records


def read(ctx):
    return records.host_wait_ms(ctx, "pairs")
