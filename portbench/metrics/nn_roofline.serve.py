"""nn_roofline.serve (%): the NN kernels' exhaustive-scan bound over their
device time, over the traced requests."""

from portbench import readers


def read(ctx):
    return readers.nn_roofline(ctx)
