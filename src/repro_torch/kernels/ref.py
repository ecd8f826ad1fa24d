"""Plain PyTorch oracles for the paged decode kernels.

They gather each row's pages into a contiguous view and run the dense
masked forms of :mod:`repro_torch.core` — the gather the kernels replace.
``kernels.paged`` uses them as the kernels' plain versions: the CPU path
of the wrappers, and the yardstick the CUDA kernels are held against.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.dotprod import dot_product_attention
from repro_torch.core.inhibitor import inhibitor_attention


def _gather_paged(k_pool, v_pool, block_tables):
    """(num_pages, ps, h_kv, d) pools + (b, P) tables -> contiguous
    (b, P*ps, h_kv, d) views."""
    idx = block_tables.long()
    kt, vt = k_pool[idx], v_pool[idx]
    b, npg, ps, hk, d = kt.shape
    return (kt.reshape(b, npg * ps, hk, d), vt.reshape(b, npg * ps, hk, d))


def _decode_mask(n_k: int, lengths, window: Optional[int]):
    """(b, 1, 1, n_k) attendability of each gathered position for the
    single decode query at position lengths[row]-1."""
    kj = torch.arange(n_k, device=lengths.device)[None, :]
    lens = lengths.long()[:, None]
    m = kj < lens
    if window is not None:
        m = m & (kj > (lens - 1) - window)
    return m[:, None, None, :]


def paged_flash_inhibitor_ref(q, k_pool, v_pool, block_tables, lengths, *,
                              score_scale=None, score_shift=0.5, signed=True,
                              normalize=True, window=None):
    """Oracle for the paged inhibitor decode kernel (gather + fused)."""
    kc, vc = _gather_paged(k_pool, v_pool, block_tables)
    mask = _decode_mask(kc.shape[1], lengths, window)
    return inhibitor_attention(
        q, kc.to(q.dtype), vc.to(q.dtype), mask=mask,
        score_scale=score_scale, score_shift=score_shift, signed=signed,
        normalize=normalize)


def paged_flash_attention_ref(q, k_pool, v_pool, block_tables, lengths, *,
                              score_scale=None, window=None):
    """Oracle for the paged Softmax decode kernel (gather + fused).  A row
    with no attendable key (length 0) outputs 0, as the kernel does (the
    dense Softmax alone would average the masked values)."""
    kc, vc = _gather_paged(k_pool, v_pool, block_tables)
    mask = _decode_mask(kc.shape[1], lengths, window)
    out = dot_product_attention(q, kc.to(q.dtype), vc.to(q.dtype),
                                mask=mask, score_scale=score_scale)
    return torch.where(mask.any(-1)[..., None], out, torch.zeros_like(out))
