"""The paged kernels' frozen ``bound`` over their device time in the
traced decode steps, in %."""

from harness.readers import paged_roofline_pct


def read(r):
    return paged_roofline_pct(r)
