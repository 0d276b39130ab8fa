"""host_reads.serve (reads/pair): the program's synchronizing reads (each a
copy to the host that waits for the device), per pair."""

from portbench import records


def read(ctx):
    return records.host_reads(ctx, "pairs")
