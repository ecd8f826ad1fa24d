"""Share of the traced slice with no device record running, in %."""

from harness.readers import idle_pct


def read(r):
    return idle_pct(r)
