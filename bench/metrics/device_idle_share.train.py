"""Share of the traced steps' ranges with no device record running, in %."""

from harness.readers import idle_pct


def read(r):
    return idle_pct(r, "bench.train_step")
