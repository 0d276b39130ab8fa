"""pairs_per_s (pairs/s): pairs returned certified, over the window
seconds."""


def read(ctx):
    return ctx["certified"] / ctx["window_s"] if ctx["window_s"] else None
