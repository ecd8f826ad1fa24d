"""Parameter initializers: draws from a ``torch.Generator``, on the
generator's own device (a CPU generator gives the same values whatever
device the result goes to; a CUDA generator draws on the card).  On the
``meta`` device nothing is drawn: the result is a shape-only stand-in
(the dry-run's parameter structs, at any size)."""

from __future__ import annotations

from typing import Sequence

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
