"""Feed-forward blocks: classic ReLU/GELU MLP (paper eq. 4) and the gated
SiLU (SwiGLU) variant of the llama family.

A block handed as a :class:`~repro_torch.distributed.sharding.ModelShards`
holds this ``model`` rank's slice of the hidden width: the up projections
are column-parallel, the down projection row-parallel, its bias added
after the reduce."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import into_region, is_split
from repro_torch.nn.linear import apply_dense, dense_axes, init_dense

_ACT = {
    "relu": F.relu,
    # the reference's gelu is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "tanh": torch.tanh,
}


def init_mlp(gen: torch.Generator, embed_dim: int, hidden_dim: int, *,
             use_bias: bool = False, dtype=torch.float32,
             device=None) -> dict:
    """Two-layer MLP (paper eq. 4): x -> act(x W1 + b1) W2 + b2."""
    kw = dict(use_bias=use_bias, dtype=dtype, device=device)
    return {"wi": init_dense(gen, (embed_dim,), (hidden_dim,), **kw),
            "wo": init_dense(gen, (hidden_dim,), (embed_dim,), **kw)}


def mlp_axes(*, use_bias: bool = False) -> dict:
    return {"wi": dense_axes(("embed",), ("mlp",), use_bias=use_bias),
            "wo": dense_axes(("mlp",), ("embed",), use_bias=use_bias)}


def apply_mlp(params: dict, x: torch.Tensor, *, activation: str = "relu",
              compute_dtype=None) -> torch.Tensor:
    x = into_region(params, x)
    h = _ACT[activation](apply_dense(params["wi"], x, 1, compute_dtype))
    return apply_dense(params["wo"], h, 1, compute_dtype,
                       reduce=is_split(params))


def init_gated_mlp(gen: torch.Generator, embed_dim: int, hidden_dim: int,
                   *, use_bias: bool = False, dtype=torch.float32,
                   device=None) -> dict:
    """SwiGLU-style gated MLP: x -> (act(x Wg) * (x Wu)) Wd."""
    kw = dict(use_bias=use_bias, dtype=dtype, device=device)
    return {"wg": init_dense(gen, (embed_dim,), (hidden_dim,), **kw),
            "wu": init_dense(gen, (embed_dim,), (hidden_dim,), **kw),
            "wd": init_dense(gen, (hidden_dim,), (embed_dim,), **kw)}


def gated_mlp_axes(*, use_bias: bool = False) -> dict:
    up = dense_axes(("embed",), ("mlp",), use_bias=use_bias)
    return {"wg": up, "wu": dict(up),
            "wd": dense_axes(("mlp",), ("embed",), use_bias=use_bias)}


def apply_gated_mlp(params: dict, x: torch.Tensor, *,
                    activation: str = "silu", compute_dtype=None,
                    reduce: bool = True) -> torch.Tensor:
    """``reduce`` False: a split block returns its row-parallel partial
    sum, for the caller to reduce with other partials (a block without
    biases: the MoE's shared expert)."""
    x = into_region(params, x)
    g = _ACT[activation](apply_dense(params["wg"], x, 1, compute_dtype))
    u = apply_dense(params["wu"], x, 1, compute_dtype)
    return apply_dense(params["wd"], g * u, 1, compute_dtype,
                       reduce=reduce and is_split(params))
