"""The window's least time (products at the bf16 peak, the inhibitor's
operations at the float32 instruction rate) over its wall time, in %."""

from harness.readers import train_mfu_pct


def read(r):
    return train_mfu_pct(r)
