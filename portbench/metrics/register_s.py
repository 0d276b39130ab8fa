"""register_s (s): window seconds per registration returned certified
(one pair a request); an uncertified answer is a failure, not work."""


def read(ctx):
    return ctx["window_s"] / ctx["certified"] if ctx["certified"] else None
