"""bnb_ms.register (ms): the program's "bnb" span (GoICP's outer SO(3)
search, the inner BnB and the refine ICPs inside it), host ms per
request."""

from portbench import records


def read(ctx):
    return records.span_ms(ctx, "bnb")
