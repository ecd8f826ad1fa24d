"""Parameter initializers: draws from a ``torch.Generator``, on the
generator's own device (a CPU generator gives the same values whatever
device the result goes to; a CUDA generator draws on the card).  On the
``meta`` device nothing is drawn: the result is a shape-only stand-in
(the dry-run's parameter structs, at any size)."""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import torch

# stddev of a unit normal truncated to [-2, 2]; dividing by it restores
# the requested stddev (same correction as the reference initializer)
_TRUNC_STD = 0.87962566103423978


def _meta(device) -> bool:
    return device is not None and torch.device(device).type == "meta"


def truncated_normal(gen: torch.Generator, shape: Sequence[int], std: float,
                     *, dtype=torch.float32, device=None) -> torch.Tensor:
    if _meta(device):
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    x = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x * (std / _TRUNC_STD)).to(device=device, dtype=dtype)


def normal(gen: torch.Generator, shape: Sequence[int], std: float, *,
           dtype=torch.float32, device=None) -> torch.Tensor:
    if _meta(device):
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * std).to(device=device, dtype=dtype)


# The reference's initializer family.  Each factory returns
# ``init(gen, shape, *, dtype=torch.float32, device=None)``; ``zeros`` and
# ``ones`` are such functions themselves and draw nothing.

def zeros(gen: torch.Generator, shape: Sequence[int], *,
          dtype=torch.float32, device=None) -> torch.Tensor:
    del gen
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def ones(gen: torch.Generator, shape: Sequence[int], *,
         dtype=torch.float32, device=None) -> torch.Tensor:
    del gen
    return torch.ones(tuple(shape), dtype=dtype, device=device)


def fans(shape: Sequence[int], in_axis: int = -2,
         out_axis: int = -1) -> Tuple[float, float]:
    """(fan_in, fan_out): the in / out axis times the receptive field
    (the product of the other axes); a vector's length for both, 1 for a
    scalar."""
    if len(shape) < 1:
        return 1.0, 1.0
    if len(shape) == 1:
        return float(shape[0]), float(shape[0])
    receptive = 1.0
    for i, d in enumerate(shape):
        if i not in (in_axis % len(shape), out_axis % len(shape)):
            receptive *= d
    return shape[in_axis] * receptive, shape[out_axis] * receptive


def variance_scaling(scale: float, mode: str, distribution: str,
                     in_axis: int = -2, out_axis: int = -1) -> Callable:
    """Variance scale / fan (``mode``: fan_in, fan_out or fan_avg) drawn
    from a normal truncated to ±2 std (rescaled to the variance), a
    normal, or a uniform of that variance."""

    def _init(gen, shape, *, dtype=torch.float32, device=None):
        fan_in, fan_out = fans(shape, in_axis, out_axis)
        if mode == "fan_in":
            denom = max(1.0, fan_in)
        elif mode == "fan_out":
            denom = max(1.0, fan_out)
        elif mode == "fan_avg":
            denom = max(1.0, (fan_in + fan_out) / 2.0)
        else:
            raise ValueError(mode)
        var = scale / denom
        if distribution == "truncated_normal":
            return truncated_normal(gen, shape, math.sqrt(var), dtype=dtype,
                                    device=device)
        if distribution == "normal":
            return normal(gen, shape, math.sqrt(var), dtype=dtype,
                          device=device)
        if distribution == "uniform":
            if _meta(device):
                return torch.empty(tuple(shape), dtype=dtype, device="meta")
            lim = math.sqrt(3.0 * var)
            x = torch.rand(tuple(shape), generator=gen, dtype=torch.float32,
                           device=gen.device)
            return (x * (2 * lim) - lim).to(device=device, dtype=dtype)
        raise ValueError(distribution)

    return _init


def lecun_normal(in_axis: int = -2, out_axis: int = -1) -> Callable:
    return variance_scaling(1.0, "fan_in", "truncated_normal", in_axis,
                            out_axis)


def xavier_uniform(in_axis: int = -2, out_axis: int = -1) -> Callable:
    return variance_scaling(1.0, "fan_avg", "uniform", in_axis, out_axis)


def he_normal(in_axis: int = -2, out_axis: int = -1) -> Callable:
    return variance_scaling(2.0, "fan_in", "truncated_normal", in_axis,
                            out_axis)


def embedding_init(stddev: float = 0.02) -> Callable:
    def _init(gen, shape, *, dtype=torch.float32, device=None):
        return normal(gen, shape, stddev, dtype=dtype, device=device)

    return _init
