"""LayerNorm, RMSNorm and GroupNorm; statistics always in float32."""

from __future__ import annotations

import torch


def init_layernorm(embed_dim: int, *, use_bias: bool = True,
                   dtype=torch.float32, device=None) -> dict:
    p = {"scale": torch.ones(embed_dim, dtype=dtype, device=device)}
    if use_bias:
        p["bias"] = torch.zeros(embed_dim, dtype=dtype, device=device)
    return p


def layernorm_axes(*, use_bias: bool = True) -> dict:
    """Logical axes of :func:`init_layernorm`'s tree (and of
    :func:`init_rmsnorm`'s without the bias, of :func:`init_groupnorm`'s
    with it)."""
    axes = {"scale": ("embed",)}
    if use_bias:
        axes["bias"] = ("embed",)
    return axes


def apply_layernorm(params: dict, x: torch.Tensor, *,
                    eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float()
    if "bias" in params:
        y = y + params["bias"].float()
    return y.to(x.dtype)


def init_rmsnorm(embed_dim: int, *, dtype=torch.float32,
                 device=None) -> dict:
    return {"scale": torch.ones(embed_dim, dtype=dtype, device=device)}


def apply_rmsnorm(params: dict, x: torch.Tensor, *,
                  eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * params["scale"].float()).to(x.dtype)


def init_groupnorm(num_groups: int, embed_dim: int, *, dtype=torch.float32,
                   device=None) -> dict:
    if embed_dim % num_groups:
        raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                         f"num_groups {num_groups}")
    return {"scale": torch.ones(embed_dim, dtype=dtype, device=device),
            "bias": torch.zeros(embed_dim, dtype=dtype, device=device)}


def apply_groupnorm(params: dict, x: torch.Tensor, num_groups: int, *,
                    eps: float = 1e-5) -> torch.Tensor:
    """Normalize each of ``num_groups`` equal slices of the last axis."""
    xf = x.float()
    *lead, d = xf.shape
    g = xf.reshape(*lead, num_groups, d // num_groups)
    mean = g.mean(-1, keepdim=True)
    var = (g - mean).square().mean(-1, keepdim=True)
    y = ((g - mean) * torch.rsqrt(var + eps)).reshape(*lead, d)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)
