"""bounds_roofline.register (%): the bound kernels' device time in the
traced requests against the bound of the work those requests' own counts
report (`roofline_bounds.py`)."""

from portbench import roofline_bounds


def read(ctx):
    return roofline_bounds.share(ctx)
