"""construct_ms.register (ms): GoICP construction (normalisation, proxy
FPS, source clusters) per request, a synchronized span."""

from portbench import readers


def read(ctx):
    return readers.span_ms(ctx, "construct")
