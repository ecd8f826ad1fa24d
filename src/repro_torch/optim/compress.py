"""Gradient compression for cross-pod data parallelism.

Port of :mod:`repro.optim.compress`.  At multi-pod scale the ``pod``
all-reduce crosses the slowest links, so gradients are compressed to int8
with a per-tensor scale before the cross-pod reduction and decompressed
after.  An error-feedback accumulator (Seide et al.; the 1-bit SGD
lineage) carries the quantization residual into the next step, so the
compression error does not bias convergence: the residual of each element
is at most ``scale / 2`` (in float32, up to the rounding of the division
and the subtraction, 2 · 127 · 2^-24 of the scale).

The intra-pod reduction runs at full precision (cheap links), then the
int8 payload crosses pods (:func:`repro_torch.distributed.collectives.
compressed_grad_sync`): 4x fewer wire bytes on the slow hop.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class CompressionState(NamedTuple):
    error: Any            # error-feedback residual, same tree as grads


def init_compression(grads_like) -> CompressionState:
    return CompressionState(error=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as an IEEE division on every device: CUDA turns a
    division by a Python scalar into a multiplication by its reciprocal,
    which rounds differently (the card would then quantize other values
    than the CPU)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def int8_scale(x: torch.Tensor) -> torch.Tensor:
    """The per-tensor scale: max |x| (at least 1e-12) over 127."""
    return divide(torch.clamp(x.abs().max(), min=1e-12), 127.0)


def compress(g: torch.Tensor, err: torch.Tensor) -> Tuple[torch.Tensor,
                                                          torch.Tensor,
                                                          torch.Tensor]:
    """g + err -> (int8 payload, scale, new_err)."""
    gf = g.float() + err
    scale = int8_scale(gf)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_err = gf - q.float() * scale
    return q, scale, new_err


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads, state: CompressionState):
    """Tree version.  Returns ((q_tree, scale_tree), new_state)."""
    out = [compress(g, e) for g, e in zip(tree_leaves(grads),
                                          tree_leaves(state.error))]
    qs, scales, errs = zip(*out) if out else ((), (), ())
    return ((tree_unflatten(grads, qs), tree_unflatten(grads, scales)),
            CompressionState(error=tree_unflatten(grads, errs)))


def decompress_tree(q_tree, scale_tree):
    return tree_map(decompress, q_tree, scale_tree)
