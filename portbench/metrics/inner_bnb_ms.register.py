"""inner_bnb_ms.register (ms): GoICP's inner R^3 BnB (_evaluate_children)
per request, a synchronized span."""

from portbench import readers


def read(ctx):
    return readers.span_ms(ctx, "inner_bnb")
