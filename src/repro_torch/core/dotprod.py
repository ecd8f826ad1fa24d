"""Conventional scaled-dot-product Softmax attention (paper eq. 3), forward.

The paper's comparison baseline, in the same multi-head GQA layout as
:mod:`repro_torch.core.inhibitor`.  Math in float32.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.inhibitor import _repeat_kv

NEG_INF = -1e9


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, mask: Optional[torch.Tensor] = None,
                          score_scale: Optional[float] = None
                          ) -> torch.Tensor:
    """q: (b, n_q, h, d); k, v: (b, n_k, h_kv, d). Returns (b, n_q, h, d)."""
    b, n_q, h, d = q.shape
    h_kv = k.shape[2]
    k = _repeat_kv(k, h // h_kv)
    v = _repeat_kv(v, h // h_kv)
    scale = score_scale if score_scale is not None else float(d) ** 0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / scale
    if mask is not None:
        mask = mask.expand(b, h, n_q, k.shape[1])
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)
