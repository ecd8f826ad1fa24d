"""The least time of every prefill chunk and decode step of the window
over its wall time, in %."""

from harness.readers import serve_mfu_pct


def read(r):
    return serve_mfu_pct(r)
