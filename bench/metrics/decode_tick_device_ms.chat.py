"""Device ms of the decode step (the tick's last graph replay) per
traced tick that decodes."""

from harness.readers import decode_device_ms


def read(r):
    return decode_device_ms(r)
