"""The frozen ``flash_bound`` of one ``flash_inhibitor_kernel`` call
over its mean device time in the traced steps, in %."""

from harness.readers import flash_roofline_pct


def read(r):
    return flash_roofline_pct(r)
