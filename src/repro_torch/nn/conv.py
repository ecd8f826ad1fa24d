"""Convolution layers in the reference's channels-last layout.

Port of :mod:`repro.nn.conv`: ``apply_conv1d`` takes (batch, T, C_in)
with a (kernel, C_in, C_out) kernel ("NWC" / "WIO"), ``apply_conv2d``
(batch, H, W, C_in) with a (kh, kw, C_in, C_out) kernel ("NHWC" /
"HWIO").  No model of the repo calls them: the production audio and
vision frontends are stubs that consume precomputed embeddings.

``padding`` is ``"SAME"`` or ``"VALID"`` as in ``lax.conv_general_dilated``.
SAME gives ceil(n / stride) outputs and pads ``max((out - 1) * stride +
k - n, 0)`` elements, the odd one on the high side; torch's own
``padding="same"`` refuses a stride other than 1, so the padding is
computed here and applied with ``F.pad``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.nn.init import he_normal


def init_conv2d(gen: torch.Generator, in_ch: int, out_ch: int,
                kernel: Tuple[int, int], *, use_bias: bool = True,
                dtype=torch.float32, device=None) -> dict:
    kh, kw = kernel
    p = {"kernel": he_normal()(gen, (kh, kw, in_ch, out_ch), dtype=dtype,
                               device=device)}
    if use_bias:
        p["bias"] = torch.zeros((out_ch,), dtype=dtype, device=device)
    return p


def init_conv1d(gen: torch.Generator, in_ch: int, out_ch: int, kernel: int,
                *, use_bias: bool = True, dtype=torch.float32,
                device=None) -> dict:
    p = {"kernel": he_normal()(gen, (kernel, in_ch, out_ch), dtype=dtype,
                               device=device)}
    if use_bias:
        p["bias"] = torch.zeros((out_ch,), dtype=dtype, device=device)
    return p


def conv_axes(ndim: int, *, use_bias: bool = True) -> dict:
    """Logical axes of :func:`init_conv2d` (``ndim`` 4) and
    :func:`init_conv1d` (``ndim`` 3): the output channels on ``"mlp"``."""
    axes = {"kernel": (None,) * (ndim - 1) + ("mlp",)}
    if use_bias:
        axes["bias"] = ("mlp",)
    return axes


def same_padding(n: int, k: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of one spatial axis under ``"SAME"``."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _padding(spatial: Sequence[int], kernel: Sequence[int],
             stride: Sequence[int], padding: str) -> list:
    """``F.pad`` widths, last spatial axis first."""
    if padding == "VALID":
        return [0, 0] * len(spatial)
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    widths = []
    for n, k, s in reversed(list(zip(spatial, kernel, stride))):
        widths += same_padding(n, k, s)
    return widths


def apply_conv2d(params: dict, x: torch.Tensor, *,
                 stride: Tuple[int, int] = (1, 1),
                 padding: str = "SAME") -> torch.Tensor:
    """x: (batch, H, W, C_in) -> (batch, H', W', C_out)."""
    w = params["kernel"].to(x.dtype)                  # (kh, kw, in, out)
    xc = x.permute(0, 3, 1, 2)                        # NCHW
    xc = F.pad(xc, _padding(x.shape[1:3], w.shape[:2], stride, padding))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=tuple(stride))
    y = y.permute(0, 2, 3, 1)
    if "bias" in params:
        y = y + params["bias"].to(x.dtype)
    return y


def apply_conv1d(params: dict, x: torch.Tensor, *, stride: int = 1,
                 padding: str = "SAME") -> torch.Tensor:
    """x: (batch, T, C_in) -> (batch, T', C_out)."""
    w = params["kernel"].to(x.dtype)                  # (k, in, out)
    xc = F.pad(x.transpose(1, 2),
               _padding(x.shape[1:2], w.shape[:1], (stride,), padding))
    y = F.conv1d(xc, w.permute(2, 1, 0), stride=stride).transpose(1, 2)
    if "bias" in params:
        y = y + params["bias"].to(x.dtype)
    return y
