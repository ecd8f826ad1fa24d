"""Device ms of one prefill chunk's step: the mean over the complete
``repro_torch.serve.prefill_chunk`` ranges of the traced ticks."""

from harness.spans import prefill_chunk_device_ms


def read(r):
    return prefill_chunk_device_ms(r)
