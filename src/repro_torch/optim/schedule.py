"""Learning-rate schedules (warmup + cosine/linear decay).

Port of :mod:`repro.optim.schedule`.  Each schedule maps a step (an int
or a 0-d tensor) to a 0-d float32 tensor on the step's device, with the
reference's order of operations.
"""

from __future__ import annotations

import math

import torch


def _step_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def lr(step):
        s = _step_f32(step)
        warm = peak_lr * s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup_steps, warm, peak_lr * cos)

    return lr


def warmup_linear(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.0):
    def lr(step):
        s = _step_f32(step)
        warm = peak_lr * s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        lin = 1.0 - (1.0 - final_frac) * prog
        return torch.where(s < warmup_steps, warm, peak_lr * lin)

    return lr


def constant(lr_value: float):
    def lr(step):
        return torch.full((), lr_value, dtype=torch.float32,
                          device=torch.as_tensor(step).device)

    return lr
