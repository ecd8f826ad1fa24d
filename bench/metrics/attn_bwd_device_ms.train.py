"""Device ms a traced step spends under the program's
``repro_torch.flash_backward`` ranges: the inhibitor's backward."""

from harness.readers import backward_ms_per_step


def read(r):
    return backward_ms_per_step(r)
