"""Device ms a traced step spends under the program's
``repro_torch.train.forward`` range: the forward and the cross-entropy."""

from harness.spans import forward_device_ms


def read(r):
    return forward_device_ms(r)
