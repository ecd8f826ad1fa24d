"""Blocked inhibitor attention: flash-structured, exact, plain torch.

Port of :mod:`repro.core.blocked`, the ``blocked`` backend of the
inhibitor mechanisms.  The fused eq. 9/10 forms contract (n_q, n_k, d)
difference cubes, and eager PyTorch materialises them; this backend
bounds each cube by a (chunk_q, chunk_k) tile:

  * forward: a two-level loop over query chunks x key chunks; each chunk
    pair runs :func:`repro_torch.core.inhibitor._inhibitor_core`, the
    masked fused inhibition, unnormalized, on a (cq, ck, d) tile.  Inhibition
    is a plain sum over keys (no Softmax normaliser), so the chunk
    partials and key counts add up exactly.  A chunk pair that no query
    attends adds exactly 0 and is skipped.
  * backward: a :class:`torch.autograd.Function` whose residuals are only
    (q, k, v).  Each chunk pair's analytic gradient is
    :func:`repro_torch.core.inhibitor._inhibitor_core_bwd` on that tile
    (the reference's ``_chunk_bwd``): dq accumulates per query chunk over
    key chunks, dk and dv per key chunk over query chunks, in one pass.
    No cube or score matrix outlives its chunk.
  * masks (causal, sliding window, KV valid length) come from chunk
    indices through :func:`repro_torch.core.attention.
    structural_mask_predicate`, as (cq, ck) tiles, never (n_q, n_k)
    arrays.  The query offset and the valid length are scalars shared by
    every row (the planner sends ragged per-slot cursors elsewhere).

Chunk sizes default to the reference's 512 x 512 and shrink by its rule
(:func:`_auto_chunks`) until the live (b, h, cq, ck, d) float32 cube fits
:data:`CUBE_BUDGET_BYTES`.  The reference divides the global batch and
heads by the mesh degrees; the port's shapes are already the local ones
(the sharded step runs the model on each rank's rows, and every model
rank computes all heads), so they count whole and are not divided
again.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.inhibitor import (_inhibitor_core, _inhibitor_core_bwd,
                                        _repeat_kv)

DEFAULT_CHUNK_Q = 512
DEFAULT_CHUNK_K = 512
CUBE_BUDGET_BYTES = 384 * 1024 * 1024


def _auto_chunks(b: int, h: int, d: int, chunk_q: int, chunk_k: int):
    """Halve (chunk_q, chunk_k), the larger first, until the float32
    difference cube of one chunk pair fits :data:`CUBE_BUDGET_BYTES`."""
    while (b * h * chunk_q * chunk_k * d * 4 > CUBE_BUDGET_BYTES
           and (chunk_q > 64 or chunk_k > 64)):
        if chunk_k >= chunk_q and chunk_k > 64:
            chunk_k //= 2
        else:
            chunk_q //= 2
    return max(chunk_q, 8), max(chunk_k, 8)


class _Hyper(NamedTuple):
    gamma: float
    shift: float
    signed: bool
    normalize: bool
    causal: bool
    window: Optional[int]
    q_offset: int
    kv_len: int
    cq: int
    ck: int


def _chunk_mask(q0: int, q1: int, k0: int, k1: int, hp: _Hyper, device):
    """(q1 - q0, k1 - k0) bool mask of the chunk pair: key j attended by
    query i (at position q_offset + i) iff j < kv_len and the structure
    allows it."""
    from repro_torch.core.attention import structural_mask_predicate

    qi = hp.q_offset + torch.arange(q0, q1, device=device)[:, None]
    kj = torch.arange(k0, k1, device=device)[None, :]
    m = (kj < hp.kv_len).expand(q1 - q0, k1 - k0)
    s = structural_mask_predicate(hp.causal, hp.window, qi, kj)
    return m if s is None else m & s


def _pairs(n_q: int, n_k: int, hp: _Hyper, device):
    """Every chunk pair with at least one attended (query, key):
    [(q0, q1, k0, k1, mask)]."""
    out = []
    for q0 in range(0, n_q, hp.cq):
        q1 = min(q0 + hp.cq, n_q)
        for k0 in range(0, n_k, hp.ck):
            k1 = min(k0 + hp.ck, n_k)
            m = _chunk_mask(q0, q1, k0, k1, hp, device)
            if bool(m.any()):
                out.append((q0, q1, k0, k1, m))
    return out


def _counts(n_q: int, pairs, device) -> torch.Tensor:
    """(n_q, 1) float32 attended-key count of every query."""
    cnt = torch.zeros((n_q, 1), dtype=torch.float32, device=device)
    for q0, q1, _, _, m in pairs:
        cnt[q0:q1, 0] += m.sum(-1)
    return cnt


def _blocked_fwd(qt, kt, vt, hp: _Hyper) -> torch.Tensor:
    """(b, h, n, d) operands -> (b, h, n_q, d) float32."""
    qf, kf, vf = qt.float(), kt.float(), vt.float()
    n_q, n_k = qf.shape[-2], kf.shape[-2]
    pairs = _pairs(n_q, n_k, hp, qf.device)
    out = torch.zeros(qf.shape, dtype=torch.float32, device=qf.device)
    for q0, q1, k0, k1, m in pairs:
        out[..., q0:q1, :] += _inhibitor_core(
            qf[..., q0:q1, :], kf[..., k0:k1, :], vf[..., k0:k1, :], m,
            gamma=hp.gamma, shift=hp.shift, signed=hp.signed,
            normalize=False)
    if hp.normalize:
        out = out / _counts(n_q, pairs, qf.device).clamp(min=1.0)
    return out


def _blocked_bwd(qt, kt, vt, g, hp: _Hyper):
    """(dq, dk, dv) of :func:`_blocked_fwd` for the output cotangent
    ``g``: each chunk pair's analytic gradient, dq summed over key chunks
    and dk, dv over query chunks."""
    qf, kf, vf, gf = (t.float() for t in (qt, kt, vt, g))
    n_q, n_k = qf.shape[-2], kf.shape[-2]
    pairs = _pairs(n_q, n_k, hp, qf.device)
    if hp.normalize:
        gf = gf / _counts(n_q, pairs, qf.device).clamp(min=1.0)
    dq, dk, dv = (torch.zeros_like(t) for t in (qf, kf, vf))
    for q0, q1, k0, k1, m in pairs:
        dq_c, dk_c, dv_c = _inhibitor_core_bwd(
            qf[..., q0:q1, :], kf[..., k0:k1, :], vf[..., k0:k1, :], m,
            gf[..., q0:q1, :], gamma=hp.gamma, shift=hp.shift,
            signed=hp.signed, normalize=False, kv_chunk=hp.ck)
        dq[..., q0:q1, :] += dq_c
        dk[..., k0:k1, :] += dk_c
        dv[..., k0:k1, :] += dv_c
    return dq.to(qt.dtype), dk.to(kt.dtype), dv.to(vt.dtype)


class _BlockedCore(torch.autograd.Function):
    """(qt, kt, vt) -> H, all (b, h, n, d); residuals (q, k, v) only."""

    @staticmethod
    def forward(ctx, qt, kt, vt, hp):
        ctx.save_for_backward(qt, kt, vt)
        ctx.hp = hp
        return _blocked_fwd(qt, kt, vt, hp)

    @staticmethod
    def backward(ctx, g):
        return _blocked_bwd(*ctx.saved_tensors, g, ctx.hp) + (None,)


def _scalar(x, name: str) -> int:
    t = torch.as_tensor(x)
    if t.numel() != 1:
        raise ValueError(f"blocked inhibitor: {name} must be one value "
                         f"shared by every row, got shape {tuple(t.shape)}")
    return int(t.reshape(()))


def blocked_inhibitor_attention(
    q: torch.Tensor,            # (b, n_q, h, d)
    k: torch.Tensor,            # (b, n_k, h_kv, d)
    v: torch.Tensor,
    *,
    score_scale: Optional[float] = None,
    score_shift: float = 0.5,
    signed: bool = True,
    normalize: bool = True,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset=0,
    kv_valid_len=None,
    chunk_q: int = DEFAULT_CHUNK_Q,
    chunk_k: int = DEFAULT_CHUNK_K,
) -> torch.Tensor:
    """Flash-structured inhibitor attention (exact; structural masks only)
    -> (b, n_q, h, d) in q.dtype.

    Equals :func:`repro_torch.core.inhibitor.inhibitor_attention` under a
    causal / sliding-window / valid-length mask with O(chunk^2 d) live
    memory; differentiable in q, k and v.  ``q_offset`` and
    ``kv_valid_len`` are ints or one-element tensors."""
    b, n_q, h, d = q.shape
    n_k, h_kv = k.shape[1], k.shape[2]
    chunk_q, chunk_k = _auto_chunks(b, h, d, chunk_q, chunk_k)
    hp = _Hyper(
        gamma=float(score_scale if score_scale is not None else d ** 0.5),
        shift=float(score_shift), signed=bool(signed),
        normalize=bool(normalize), causal=bool(causal),
        window=None if window is None else int(window),
        q_offset=_scalar(q_offset, "q_offset"),
        kv_len=(n_k if kv_valid_len is None
                else _scalar(kv_valid_len, "kv_valid_len")),
        cq=min(chunk_q, max(n_q, 1)), ck=min(chunk_k, max(n_k, 1)))
    qt = q.transpose(1, 2)
    kt = _repeat_kv(k, h // h_kv).transpose(1, 2)
    vt = _repeat_kv(v, h // h_kv).transpose(1, 2)
    out = _BlockedCore.apply(qt, kt, vt, hp)
    return out.transpose(1, 2).to(q.dtype)
