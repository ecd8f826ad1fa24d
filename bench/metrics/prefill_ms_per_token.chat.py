"""Host ms of the engine's ``prefill_pass`` telemetry spans in the
window over the prompt tokens its counters say were prefilled."""

from harness.readers import prefill_ms_per_token


def read(r):
    return prefill_ms_per_token(r)
