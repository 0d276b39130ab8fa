"""host_wait_ms.register (ms): the program's host_wait_s, the host's time
blocked in its synchronizing reads (waiting for the device), per
request."""

from portbench import records


def read(ctx):
    return records.host_wait_ms(ctx, "requests")
