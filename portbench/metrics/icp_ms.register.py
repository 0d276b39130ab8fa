"""icp_ms.register (ms): GoICP's ICP phases (initial, refine, spawn,
final) per request, synchronized spans."""

from portbench import readers


def read(ctx):
    return readers.span_ms(ctx, "icp")
