"""Plain PyTorch oracles for the port's kernels.

Port of :mod:`repro.kernels.ref`: thin reorderings of the dense masked
forms of :mod:`repro_torch.core`, so the kernels and the model code share
one source of truth.

  * :func:`flash_inhibitor_ref` / :func:`flash_attention_ref` — the
    blockwise prefill kernels' oracles (structural causal / window masks
    from indices, queries at positions 0..n_q-1); :func:`prefill_mask`
    adds the per-row decode cursors of the kernels' cached form;
  * :func:`paged_flash_inhibitor_ref` / :func:`paged_flash_attention_ref`
    — gather each row's pages into a contiguous view, then the dense
    masked forms (the gather the paged kernels replace);
  * :func:`wkv6_ref` — the exact RWKV-6 recurrence, the WKV kernel's
    oracle.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.attention import structural_mask_predicate
from repro_torch.core.dotprod import dot_product_attention
from repro_torch.core.inhibitor import inhibitor_attention
from repro_torch.nn.ssm import wkv6_scan_ref


def _mask_for(n_q: int, n_k: int, causal: bool, window: Optional[int],
              device=None):
    """(1, 1, n_q, n_k) structural mask (None when unstructured); query
    positions start at 0, and a window implies causality."""
    m = structural_mask_predicate(
        causal, window, torch.arange(n_q, device=device)[:, None],
        torch.arange(n_k, device=device)[None, :])
    return None if m is None else m[None, None]


def prefill_mask(n_q: int, n_k: int, *, causal: bool, window, cursors=None,
                 device=None):
    """The prefill kernels' mask.  Without ``cursors`` it is
    :func:`_mask_for`; with ``cursors`` ((2, b) int32: query offsets, KV
    valid lengths) it is (b, 1, n_q, n_k): row r's queries sit at
    ``cursors[0, r] + i`` and only its first ``cursors[1, r]`` keys are
    live."""
    if cursors is None:
        return _mask_for(n_q, n_k, causal, window, device)
    off, valid = cursors.long()
    qi = off[:, None, None] + torch.arange(n_q, device=device)[None, :, None]
    kj = torch.arange(n_k, device=device)[None, None, :]
    m = kj < valid[:, None, None]
    s = structural_mask_predicate(causal, window, qi, kj)
    if s is not None:
        m = m & s
    return m[:, None]


def flash_inhibitor_ref(q, k, v, *, score_scale=None, score_shift=0.5,
                        signed=True, normalize=True, causal=True,
                        window=None):
    """Oracle for kernels.inhibitor.flash_inhibitor_fwd."""
    mask = _mask_for(q.shape[1], k.shape[1], causal, window, q.device)
    return inhibitor_attention(
        q, k, v, mask=mask, score_scale=score_scale,
        score_shift=score_shift, signed=signed, normalize=normalize)


def flash_attention_ref(q, k, v, *, score_scale=None, causal=True,
                        window=None):
    """Oracle for kernels.flash.flash_attention_fwd."""
    mask = _mask_for(q.shape[1], k.shape[1], causal, window, q.device)
    return dot_product_attention(q, k, v, mask=mask, score_scale=score_scale)


def wkv6_ref(r, k, v, w, u, state=None):
    """Oracle for kernels.rwkv6.wkv6_chunked (the exact recurrence)."""
    return wkv6_scan_ref(r, k, v, w, u, state)


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
