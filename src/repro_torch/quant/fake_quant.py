"""Symmetric quantization utilities (QAT fake-quant + PTQ helpers).

Port of :mod:`repro.quant.fake_quant`.  The Inhibitor "allows
straightforward quantization": its score/inhibition path is linear in Q,
K, V up to ReLU/|·| — all scale-covariant ops — so a single shared scale
survives the whole attention computation.  These helpers provide the
integer projection used by the integer lanes and a straight-through
fake-quant for QAT.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.tree import tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    bits: int = 8
    symmetric: bool = True
    per_channel: bool = False     # quantize per last-dim channel
    narrow_range: bool = False    # use [-(2^(b-1)-1), 2^(b-1)-1]


def _qrange(cfg: QuantConfig):
    qmax = 2 ** (cfg.bits - 1) - 1
    qmin = -qmax if cfg.narrow_range else -(2 ** (cfg.bits - 1))
    return qmin, qmax


def compute_scale(x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Max-abs calibration scale (per tensor or per channel)."""
    _, qmax = _qrange(cfg)
    if cfg.per_channel:
        amax = x.abs().amax(dim=tuple(range(x.dim() - 1)), keepdim=True)
    else:
        amax = x.abs().max()
    return torch.clamp_min(amax, 1e-8) / qmax


def quantize(x: torch.Tensor, scale: torch.Tensor,
             cfg: QuantConfig) -> torch.Tensor:
    """round(x / scale) (half to even), clipped to the range, as int32."""
    qmin, qmax = _qrange(cfg)
    return torch.clamp(torch.round(x / scale), qmin, qmax).to(torch.int32)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def fake_quant(x: torch.Tensor, cfg: QuantConfig,
               scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantize-dequantize with straight-through gradients (QAT)."""
    xd = x.detach()
    s = compute_scale(xd, cfg) if scale is None else scale
    qdq = dequantize(quantize(xd, s, cfg), s)
    return x + (qdq - x).detach()


def quantize_params(tree, cfg: QuantConfig):
    """PTQ a parameter tree (nested dicts/lists of tensors) -> (int tree,
    scale tree)."""

    def one(x):
        if not x.is_floating_point():
            return x, torch.ones((), dtype=torch.float32, device=x.device)
        s = compute_scale(x, cfg)
        return quantize(x, s, cfg), s

    pairs = [one(x) for x in tree_leaves(tree)]
    return (tree_unflatten(tree, [p[0] for p in pairs]),
            tree_unflatten(tree, [p[1] for p in pairs]))

