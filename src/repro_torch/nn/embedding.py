"""Token embedding with optional logit tying, and a learned position
table.

A table handed as a :class:`~repro_torch.distributed.sharding.ModelShards`
holds this ``model`` rank's vocabulary rows: the lookup reads the ids
that fall in them (the others give zero rows) and sums over the ranks
(at the rank's positions of a sequence-parallel stream); the tied
logits are the rank's vocabulary columns."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (into_region, is_split,
                                              model_rank, region_exit)
from repro_torch.nn.init import embedding_init


def init_embedding(gen: torch.Generator, vocab_size: int, embed_dim: int,
                   *, dtype=torch.float32, device=None,
                   stddev: float = 0.02) -> dict:
    return {"table": embedding_init(stddev)(gen, (vocab_size, embed_dim),
                                            dtype=dtype, device=device)}


def embedding_axes() -> dict:
    return {"table": ("vocab", "embed")}


def apply_embedding(params: dict, token_ids: torch.Tensor,
                    compute_dtype=None) -> torch.Tensor:
    """Lookup: (...,) int -> (..., embed).  Gathers rows first, then casts
    (the same values as casting the table first, without casting rows no
    token reads)."""
    ids = token_ids.long()
    if is_split(params):
        rows = params["table"].shape[0]
        ids = ids - model_rank() * rows
        mine = (ids >= 0) & (ids < rows)
        out = F.embedding(torch.where(mine, ids, 0), params["table"])
        out = region_exit(out * mine[..., None].to(out.dtype))
    else:
        out = F.embedding(ids, params["table"])
    return out if compute_dtype is None else out.to(compute_dtype)


def attend_logits(params: dict, x: torch.Tensor,
                  compute_dtype=None) -> torch.Tensor:
    """Tied-softmax logits: (..., embed) @ table.T -> (..., vocab) (this
    rank's vocabulary columns of a split table)."""
    x = into_region(params, x)
    table = params["table"]
    if compute_dtype is not None:
        table = table.to(compute_dtype)
        x = x.to(compute_dtype)
    return x @ table.t()


def init_positional(gen: torch.Generator, max_len: int, embed_dim: int,
                    *, dtype=torch.float32, device=None,
                    stddev: float = 0.02) -> dict:
    """A learned (max_len, embed) position table."""
    return {"table": embedding_init(stddev)(gen, (max_len, embed_dim),
                                            dtype=dtype, device=device)}


def positional_axes() -> dict:
    return {"table": (None, "embed")}


def apply_positional(params: dict, positions: torch.Tensor,
                     compute_dtype=None) -> torch.Tensor:
    """Lookup: (...,) int positions -> (..., embed), gathered before the
    cast as :func:`apply_embedding` does."""
    out = F.embedding(positions.long(), params["table"])
    return out if compute_dtype is None else out.to(compute_dtype)
