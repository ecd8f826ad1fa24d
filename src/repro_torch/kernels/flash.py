"""Flash attention (dot-product Softmax), the paper's baseline mechanism,
as a blockwise forward with the online-Softmax recurrence.

:func:`flash_attention_fwd` launches the hand-written CUDA kernels of
``csrc/flash_prefill.cu``, which replace the TPU kernel
``repro/kernels/flash.py:35`` ``_flash_attention_kernel``:

* bf16 operands (the training path) run on the tensor cores
  (``flash_attention_tc_kernel``), in the shape of FlashAttention-2: one
  block per (row, query head, tile of ``block_q`` = 64 or 128 queries),
  each warp owning 16 query rows; 64-key tiles of K and V staged by
  ``cp.async`` into padded shared memory, double-buffered; S = QKᵀ and
  O += PV by ``mma.sync.m16n8k16`` on ``ldmatrix`` fragments with float32
  accumulators; the running max (from -1e30), running sum and rescale of
  O in registers.  P is split as ``p_hi = bf16(p)``, ``p_lo = bf16(p -
  p_hi)`` and both are multiplied by V, so P keeps about 16 bits (the
  reference multiplies P in float32; bf16 P alone errs by 2^-9 a term).
  Keys at or past ``min(kv_valid_len, n_k)`` enter shared memory as zeros
  (``cp.async`` zero-fill) and are never read: nan past a cursor cannot
  reach a product.  Masks are applied only on tiles that cross the
  diagonal, the window, the cursor or n_k.  Its bound at the training
  shape is 10 us of bf16 tensor-core work; ``wgmma`` on TMA-staged tiles
  and warp specialisation stand between it and that bound.
* float32 operands keep the CUDA-core kernel (``flash_attention_kernel``,
  the flash inhibitor's grid, staging, masks and launcher, with the tile
  halved to fit): TF32 products would not meet the float32 tolerance.
  The training path never launches it; the float32 parity checks do.

A row with no attended key outputs 0; otherwise out = acc / max(l,
1e-20).  The source's header note gives the design and the bound.

:func:`flash_attention_plain` is its plain version: the dense masked
Softmax of :mod:`repro_torch.core.dotprod`, with rows that attend no key
set to 0 as the kernel does.  Taken only for CPU tensors; counts as in
:mod:`repro_torch.kernels.inhibitor`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ref as kref
from repro_torch.kernels.inhibitor import (LOWERS_ON,  # noqa: F401
                                           _cursors_or_none, _layout,
                                           launch_prefill)

#: query tiles of the bf16 tensor-core kernel (16 rows per warp); the
#: float32 variant takes any tile and halves it to fit
BLOCK_QS = (64, 128)
DEFAULT_BLOCK_Q = BLOCK_QS[0]
BLOCK_K = 64                  # keys per staged tile on the tensor cores


def flash_attention_plain(q, k, v, *, score_scale=None, causal=True,
                          window=None, q_offset=None, kv_valid_len=None):
    """Plain version of the flash attention kernel."""
    flash_attention_plain.calls += 1
    from repro_torch.core.dotprod import dot_product_attention

    mask = kref.prefill_mask(
        q.shape[1], k.shape[1], causal=causal, window=window,
        cursors=_cursors_or_none(q, k, q_offset, kv_valid_len),
        device=q.device)
    out = dot_product_attention(q, k, v, mask=mask, score_scale=score_scale)
    if mask is None:
        return out
    live = mask.any(-1).transpose(1, 2)[..., None]      # (b|1, n_q, 1, 1)
    return torch.where(live, out, torch.zeros_like(out))


flash_attention_plain.calls = 0


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    score_scale: Optional[float] = None,
    causal: bool = True,
    window: Optional[int] = None,
    block_q: int = DEFAULT_BLOCK_Q,
    q_offset=None,
    kv_valid_len=None,
) -> torch.Tensor:
    """q: (b, n_q, h, d); k, v: (b, n_k, h_kv, d) -> (b, n_q, h, d).
    Cursors as :func:`repro_torch.kernels.inhibitor.flash_inhibitor_fwd`.
    In bf16 ``block_q`` must be one of :data:`BLOCK_QS` (else
    ValueError)."""
    _layout(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, score_scale=score_scale,
                                     causal=causal, window=window,
                                     q_offset=q_offset,
                                     kv_valid_len=kv_valid_len)
    scale = score_scale if score_scale is not None else math.sqrt(q.shape[-1])
    out = launch_prefill(
        "flash_attention_prefill", q, k, v,
        _cursors_or_none(q, k, q_offset, kv_valid_len), block_q=block_q,
        scale=scale, extra=(), causal=causal, window=window,
        tiles=BLOCK_QS if q.dtype == torch.bfloat16 else None)
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
