"""Plain PyTorch oracles for the port's kernels.

Port of :mod:`repro.kernels.ref`: thin reorderings of the dense masked
forms of :mod:`repro_torch.core`, so the kernels and the model code share
one source of truth.

  * :func:`flash_inhibitor_ref` / :func:`flash_attention_ref` — the
    blockwise prefill kernels' oracles (structural causal / window masks
    from indices, queries at positions 0..n_q-1); :func:`prefill_mask`
    adds the per-row decode cursors of the kernels' cached form,
    :func:`backward_mask` the training entries' query offset;
  * :func:`inhibitor_bwd_tie_allowance` — how far two float32 computations
    of the inhibitor's backward may part at pairs within rounding of a tie
    (what the backward kernel's checks on free inputs allow beyond
    summation order);
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


def backward_mask(q, k, causal: bool, window, q_offset: int):
    """The training entries' mask at the forward's cursors: queries at
    ``q_offset + i``, every key valid.  Keys past the last query are
    causally masked but live, unlike a decode cache's (whose valid length
    never passes its last query)."""
    cursors = None
    if q_offset:
        # filled on the device: no host-to-device copy
        cursors = torch.full((2, q.shape[0]), k.shape[1], dtype=torch.int32,
                             device=q.device)
        cursors[0].fill_(int(q_offset))
    return prefill_mask(q.shape[1], k.shape[1], causal=causal, window=window,
                        cursors=cursors, device=q.device)


def inhibitor_bwd_tie_allowance(q, k, v, g, *, score_scale=None,
                                score_shift=0.5, signed=True, normalize=True,
                                causal=True, window=None, q_offset: int = 0):
    """How far two float32 computations of the inhibitor's backward (the
    kernel ``kernels.inhibitor.flash_inhibitor_bwd`` and its plain version,
    operands as theirs) may part beyond summation order: at the pairs that
    lie within rounding of a tie.  Returns allowances broadcastable to dq,
    dk and dv ((b, n_q, h, 1), (b, n_k, h_kv, 1), (b, n_k, h_kv, d), float64)
    and the number of such ties (a 0-d tensor).

    raw_ij = sum_d |q_id - k_jd| / gamma, summed in any order in float32,
    lies within (d + 4) 2^-24 raw_ij of its exact value (d roundings of
    |q - k|, d - 1 additions, the scale and the shift), and so does Z_ij =
    relu(raw_ij - alpha).  Two computations can then disagree on an
    indicator 1[|v_jk| > Z_ij] (1[v_jk > Z_ij] unsigned) only where v lies
    that close to the exact Z_ij, and on a gate 1[raw_ij > alpha] only where
    raw_ij lies that close to alpha.  A flipped indicator moves dv_jk by
    |g^_ik| and each element of dq_i and dk_j by at most |g^_ik| / gamma; a
    flipped gate moves dq_i and dk_j by at most sum_k |g^_ik| / gamma (g^ =
    g / count when normalizing).  The exact scores are taken in float64."""
    b, n_q, h, d = q.shape
    n_k, kv_heads = k.shape[1], k.shape[2]
    group = h // kv_heads
    gamma = score_scale if score_scale is not None else d ** 0.5

    def per_head(x):                     # (b, n, h_kv, d) -> (b, h, n, d)
        return x.double().repeat_interleave(group, 2).transpose(1, 2)

    qt, kt, vt = q.double().transpose(1, 2), per_head(k), per_head(v)
    raw = torch.cdist(qt.reshape(b * h, n_q, d), kt.reshape(b * h, n_k, d),
                      p=1).reshape(b, h, n_q, n_k) / gamma
    eps = (d + 4) * 2.0 ** -24 * raw
    mask = backward_mask(q, k, causal, window, q_offset)
    live = (torch.ones(1, 1, n_q, n_k, dtype=torch.bool, device=q.device)
            if mask is None else mask).expand(b, h, n_q, n_k)
    z = torch.where(live, (raw - score_shift).clamp(min=0) if score_shift
                    else raw, torch.inf)
    gh = g.double().transpose(1, 2).abs()                  # (b, h, n_q, d)
    if normalize:
        gh = gh / live.sum(-1, keepdim=True).clamp(min=1)
    av = vt.abs() if signed else vt
    allow_q, allow_k = raw.new_zeros(b, h, n_q), raw.new_zeros(b, h, n_k)
    allow_v = raw.new_zeros(b, h, n_k, d)
    ties = torch.zeros((), dtype=torch.long, device=q.device)
    chunk = 16                   # keys a (b, h, n_q, chunk, d) cube holds
    for j0 in range(0, n_k, chunk):
        j1 = min(j0 + chunk, n_k)
        near = ((av[:, :, None, j0:j1] - z[..., j0:j1, None]).abs()
                <= eps[..., j0:j1, None])           # (b, h, n_q, chunk, d)
        ties += near.sum()
        w = near * gh[:, :, :, None]
        allow_v[:, :, j0:j1] += w.sum(2)
        pair = w.sum(-1)                            # (b, h, n_q, chunk)
        allow_q += pair.sum(-1) / gamma
        allow_k[:, :, j0:j1] += pair.sum(2) / gamma
    if score_shift:
        gate = live & ((raw - score_shift).abs() <= eps)
        ties += gate.sum()
        pair = gate * gh.sum(-1, keepdim=True)
        allow_q += pair.sum(-1) / gamma
        allow_k += pair.sum(2) / gamma

    def per_kv(x):                # (b, h, n_k, ...) -> (b, n_k, h_kv, ...)
        x = x.reshape(b, kv_heads, group, *x.shape[2:]).sum(2)
        return x.transpose(1, 2)

    return (allow_q.transpose(1, 2)[..., None], per_kv(allow_k)[..., None],
            per_kv(allow_v), ties)


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
