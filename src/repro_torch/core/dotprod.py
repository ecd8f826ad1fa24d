"""Conventional scaled-dot-product Softmax attention (paper eq. 3).

The paper's comparison baseline, in the same multi-head GQA layout as
:mod:`repro_torch.core.inhibitor`.  Math in float32.

Port of :mod:`repro.core.dotprod` with its lean custom VJP
(``_make_dotprod_core``) as a ``torch.autograd.Function``: plain autograd
keeps several score-sized float32 residuals per layer (logits, masked
logits, probabilities, softmax internals); here the only residual is the
probability matrix in the compute dtype, and the backward applies the
analytic Softmax Jacobian ``dS = P ⊙ (dP − Σ_k dP⊙P)``, so one
score-sized float32 tensor is live at a time.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.inhibitor import _repeat_kv

NEG_INF = -1e9


def _core_fwd(q, k, v, mask, scale: float):
    """q (b, n_q, h, d); k, v (b, n_k, h, d) -> (out float32, probs)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out, probs


class _DotprodCore(torch.autograd.Function):
    """(q, k, v, mask) -> float32 out, with the lean Softmax backward."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale: float):
        out, probs = _core_fwd(q, k, v, mask, scale)
        # masked probabilities are exactly 0: the backward needs no mask
        ctx.save_for_backward(q, k, v, probs.to(q.dtype))
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, probs = ctx.saved_tensors
        gf = g.float()
        pf = probs.float()
        dv = torch.einsum("bhqk,bqhd->bkhd", pf, gf)
        dp = torch.einsum("bqhd,bkhd->bhqk", gf, v.float())
        ds = pf * (dp - torch.sum(dp * pf, dim=-1, keepdim=True))
        del dp
        ds = ds / ctx.scale
        dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
        dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


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
    if mask is not None:
        mask = mask.expand(b, h, n_q, k.shape[1])
    return _DotprodCore.apply(q, k, v, mask, float(scale)).to(q.dtype)


def dot_product_attention_vjp(q, k, v, g, *, mask=None, score_scale=None):
    """(dq, dk, dv) of :func:`dot_product_attention` at (q, k, v) for the
    output cotangent ``g``: the forward recomputed, then the lean
    backward.  The training kernel's backward (``kernels.ops``)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = dot_product_attention(*leaves, mask=mask,
                                    score_scale=score_scale)
        return torch.autograd.grad(out, leaves, g)
