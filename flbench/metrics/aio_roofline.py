"""AIO's kernels (#6, #7, #8) against their roofline: their bound time
over their device time in the profiled rounds, in percent."""
from roofline import roofline_share

KERNELS = ("aio_aggregate", "aio_absorb", "aio_merge")


def read(ctx):
    return roofline_share(KERNELS, ctx)
