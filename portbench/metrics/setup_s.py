"""setup_s (s): from the start of the process, as the kernel records it,
to the start of the window: the interpreter, the imports, reaching the
card, the inputs, the entry's state and the warm-up."""


def read(ctx):
    return ctx["setup_s"]
