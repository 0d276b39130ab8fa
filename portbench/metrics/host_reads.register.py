"""host_reads.register (reads): the program's synchronizing reads (each a
copy to the host that waits for the device), per request."""

from portbench import records


def read(ctx):
    return records.host_reads(ctx, "requests")
