"""Flash attention (dot-product Softmax), the paper's baseline mechanism,
as a blockwise forward with the online-Softmax recurrence.

:func:`flash_attention_fwd` launches the hand-written CUDA kernel of
``csrc/flash_prefill.cu``, which replaces the TPU kernel
``repro/kernels/flash.py:35`` ``_flash_attention_kernel``.  It shares the
flash inhibitor's grid, staging, masks and launcher
(:func:`repro_torch.kernels.inhibitor.launch_prefill`); per query row it
keeps a running max (from -1e30), a running sum and a rescaled float32
accumulator, and a row with no attended key outputs 0.

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
from repro_torch.kernels.inhibitor import (DEFAULT_BLOCK_Q, LOWERS_ON,  # noqa: F401
                                           _cursors_or_none, _layout,
                                           launch_prefill)


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
    Cursors as :func:`repro_torch.kernels.inhibitor.flash_inhibitor_fwd`."""
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
        scale=scale, extra=(), causal=causal, window=window)
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
