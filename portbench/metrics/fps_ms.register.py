"""fps_ms.register (ms): the program's "construct.fps" span (every
farthest-point sampling of GoICP's construction: the proxy coreset and the
source clusters), host seconds per request."""

from portbench import records


def read(ctx):
    return records.span_ms(ctx, "construct.fps")
