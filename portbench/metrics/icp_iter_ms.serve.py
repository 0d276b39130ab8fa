"""icp_iter_ms.serve (ms): the program's "icp" span (every batched ICP
call) over the lockstep iterations it counts, host ms an iteration."""

from portbench import records


def read(ctx):
    return records.icp_iter_ms(ctx)
