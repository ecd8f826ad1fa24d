"""General dense layer: contracts the trailing input dims with a kernel
of shape ``(*in_shape, *out_shape)``."""

from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.distributed.sharding import at_positions, region_exit
from repro_torch.nn.init import truncated_normal


def init_dense(gen: torch.Generator, in_shape: Sequence[int],
               out_shape: Sequence[int], *, use_bias: bool = False,
               dtype=torch.float32, device=None) -> dict:
    """Truncated-normal kernel with stddev 1/sqrt(prod(in_shape))."""
    in_shape, out_shape = tuple(in_shape), tuple(out_shape)
    std = math.prod(in_shape) ** -0.5
    params = {"kernel": truncated_normal(gen, in_shape + out_shape, std,
                                         dtype=dtype, device=device)}
    if use_bias:
        params["bias"] = torch.zeros(out_shape, dtype=dtype, device=device)
    return params


def dense_axes(in_axes: Sequence, out_axes: Sequence, *,
               use_bias: bool = False, bias_axes=None) -> dict:
    """Logical axes of :func:`init_dense`'s tree: the kernel's
    ``(*in_axes, *out_axes)``, the bias's ``bias_axes`` (default
    ``out_axes``)."""
    axes = {"kernel": tuple(in_axes) + tuple(out_axes)}
    if use_bias:
        axes["bias"] = tuple(out_axes if bias_axes is None else bias_axes)
    return axes


def apply_dense(params: dict, x: torch.Tensor, n_in_dims: int = 1,
                compute_dtype=None, *, reduce: bool = False) -> torch.Tensor:
    """Contract the last ``n_in_dims`` dims of ``x`` with the kernel.
    ``reduce``: the kernel is this rank's rows of a row-parallel layer,
    so the product leaves its region summed over the ``model`` ranks
    (:func:`~repro_torch.distributed.sharding.region_exit`: whole, or at
    the rank's positions of a sequence-parallel stream) before the bias
    is added, once."""
    kernel = params["kernel"]
    if compute_dtype is not None:
        kernel = kernel.to(compute_dtype)
        x = x.to(compute_dtype)
    in_shape = kernel.shape[:n_in_dims]
    out_shape = kernel.shape[n_in_dims:]
    lead = x.shape[:x.dim() - n_in_dims]
    y = x.reshape(*lead, math.prod(in_shape)) @ kernel.reshape(
        math.prod(in_shape), math.prod(out_shape))
    y = y.reshape(*lead, *out_shape)
    if reduce:
        y = region_exit(y)
    if "bias" in params:
        b = at_positions(params["bias"]) if reduce else params["bias"]
        if compute_dtype is not None:
            b = b.to(compute_dtype)
        y = y + b
    return y
