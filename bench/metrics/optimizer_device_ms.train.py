"""Device ms a traced step spends under the program's
``repro_torch.train.optimizer`` range: the clip and the AdamW update."""

from harness.spans import optimizer_device_ms


def read(r):
    return optimizer_device_ms(r)
