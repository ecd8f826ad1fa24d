"""The Inhibitor attention mechanism (Brännvall & Stoian).

Port of :mod:`repro.core.inhibitor`:

  * :func:`manhattan_scores`        — eq. 5 (+ shifted-score variant)
  * :func:`inhibit_naive`           — eq. 6, broadcast form (oracle)
  * :func:`inhibit_signed_naive`    — eq. 7, broadcast form (oracle)
  * :func:`inhibit_fused`           — eq. 9, cdist-decomposed form
  * :func:`inhibit_signed_fused`    — eq. 10, cdist-decomposed form
  * :func:`inhibitor_attention`     — multi-head GQA entry point, with the
    reference's analytic custom VJP as a ``torch.autograd.Function``
  * :func:`inhibitor_attention_vjp` — that backward on its own (the
    plain version of the training backward kernel,
    ``kernels.inhibitor.flash_inhibitor_bwd``)
  * :func:`inhibitor_attention_chunked` — blockwise streaming form

Notation follows the paper: ``Z[i,j] = (1/γ)·Σ_k |Q[i,k] − K[j,k]|`` with
γ = √d, shifted score ``Z' = (Z − α)⁺``; inhibition
``H[i,k] = Σ_j (V[j,k] − Z'[i,j])⁺``.

All math runs in float32 whatever the input dtype: the sums of ReLU terms
are unnormalized and reach seq_len·|V| magnitude.  The fused forms mask by
*exclusion* from the sums; only the naive oracle masks by ``Z = MASK_Z``.

Eager PyTorch materialises the broadcast cubes that XLA fuses away:
``|q − k|`` is ``(..., n_q, n_k, d)`` and :func:`_abs_cross` builds
``(..., n_q, n_k, d_v)`` (twice for the signed form).  At the serving
slice's prefill chunks this is tens of MB per layer call; the decode hot
loop never runs it (the paged CUDA kernel does).  The backward therefore
walks the keys in chunks (:data:`BWD_KV_CHUNK`): at the training shapes
(b 8, h 9, n 1024, d 64) one whole float32 cube is 19.3 GB, one
128-key chunk of it 2.4 GB.
"""

from __future__ import annotations

from typing import Optional

import torch

MASK_Z: float = 1e9

#: keys per chunk of the analytic backward (see the module note)
BWD_KV_CHUNK = 128


def manhattan_scores(q: torch.Tensor, k: torch.Tensor, *,
                     score_scale: Optional[float] = None,
                     score_shift: float = 0.0) -> torch.Tensor:
    """Eq. 5 (+ shift): ``Z[..., i, j] = ((1/γ)·Σ_d |q_i − k_j| − α)⁺``.

    q: (..., n_q, d), k: (..., n_k, d) -> (..., n_q, n_k), float32.
    """
    d = q.shape[-1]
    gamma = score_scale if score_scale is not None else float(d) ** 0.5
    z = (q.float()[..., :, None, :] - k.float()[..., None, :, :]).abs().sum(-1)
    z = z / gamma
    if score_shift:
        z = torch.relu(z - score_shift)
    return z


def inhibit_naive(v: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Eq. 6: ``H[i,k] = Σ_j (V[j,k] − Z[i,j])⁺``."""
    vf = v.float()
    return torch.relu(vf[..., None, :, :] - z[..., :, :, None]).sum(-2)


def inhibit_signed_naive(v: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Eq. 7: ``H[i,k] = Σ_j (V⁺−Z)⁺ + Σ_j (V⁻+Z)⁻`` (signed values)."""
    vf = v.float()
    vp = torch.relu(vf)
    vn = vf - vp
    t1 = torch.relu(vp[..., None, :, :] - z[..., :, :, None])
    t2 = torch.clamp(vn[..., None, :, :] + z[..., :, :, None], max=0.0)
    return (t1 + t2).sum(-2)


def _abs_cross(a: torch.Tensor, b: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Σ_j |a[..., j, k] − b[..., i, j]|: (..., n_k, d_v), (..., n_q, n_k)
    -> (..., n_q, d_v).  ``mask`` (..., n_q, n_k) excludes pairs from the
    sum (never large constants: the eq. 9 terms cancel only exactly)."""
    cube = (a[..., None, :, :] - b[..., :, :, None]).abs()
    if mask is not None:
        cube = cube * mask[..., None].to(cube.dtype)
    return cube.sum(-2)


def _masked_col_v(vf: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Σ_j V[j,k] over attendable j: (..., n_q, d_v) (or (..., 1, d_v))."""
    if mask is None:
        return vf.sum(-2, keepdim=True)
    return mask.to(vf.dtype) @ vf


def inhibit_fused(v: torch.Tensor, z: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. 9: H = ½·Σ_j V − ½·Σ_j Z + ½·Σ_j |V − Z|  (≡ eq. 6)."""
    vf = v.float()
    col_v = _masked_col_v(vf, mask)
    zm = z if mask is None else z * mask.to(z.dtype)
    row_z = zm.sum(-1, keepdim=True)
    cross = _abs_cross(vf, z, mask)
    return 0.5 * (col_v - row_z + cross)


def inhibit_signed_fused(v: torch.Tensor, z: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. 10: H = ½·Σ_j V + ½·Σ_j|V⁺−Z| − ½·Σ_j|V⁻+Z|  (≡ eq. 7)."""
    vf = v.float()
    vp = torch.relu(vf)
    vn = vf - vp
    col_v = _masked_col_v(vf, mask)
    t_pos = _abs_cross(vp, z, mask)
    t_neg = _abs_cross(-vn, z, mask)
    return 0.5 * (col_v + t_pos - t_neg)


def mask_scores(z: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Apply a boolean mask (True = attend) by setting Z to +MASK_Z."""
    if mask is None:
        return z
    return torch.where(mask, z, torch.full_like(z, MASK_Z))


def causal_mask(n_q: int, n_k: int, *, q_offset=0,
                device=None) -> torch.Tensor:
    """(n_q, n_k) boolean causal mask; query i sits at q_offset + i."""
    qi = torch.arange(n_q, device=device)[:, None] + q_offset
    kj = torch.arange(n_k, device=device)[None, :]
    return kj <= qi


def sliding_window_mask(n_q: int, n_k: int, window: int, *, q_offset=0,
                        device=None) -> torch.Tensor:
    """(n_q, n_k) boolean mask of the causal keys within ``window`` of
    the query: key j attends to query i at q_offset + i when
    i + q_offset - window < j <= i + q_offset."""
    qi = torch.arange(n_q, device=device)[:, None] + q_offset
    kj = torch.arange(n_k, device=device)[None, :]
    return (kj <= qi) & (kj > qi - window)


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(b, s, kv_heads, d) -> (b, s, kv_heads*n_rep, d) for GQA."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def _inhibitor_core(qt, kt, vt, mask, *, gamma: float, shift: float,
                    signed: bool, normalize: bool) -> torch.Tensor:
    """(b, h, n, d) operands -> (b, h, n_q, d) float32 (the forward of the
    reference's custom-VJP core)."""
    z = manhattan_scores(qt, kt, score_scale=gamma, score_shift=shift)
    out = (inhibit_signed_fused(vt, z, mask) if signed
           else inhibit_fused(vt, z, mask))
    if normalize:
        if mask is not None:
            cnt = mask.float().sum(-1, keepdim=True)
        else:
            cnt = torch.full(z.shape[:-1] + (1,), float(kt.shape[-2]),
                             dtype=torch.float32, device=z.device)
        out = out / cnt.clamp(min=1.0)
    return out


# ---------------------------------------------------------------------------
# Analytic custom VJP of the fused core (reference: _make_inhibitor_core)
#
#   ind_ijk = 1[V_jk > Z_ij] unsigned;  1[|V_jk| > Z_ij] signed (for Z ≥ 0
#             this is the reference's V > 0 ? V⁺ > Z : V⁻ + Z < 0)
#   dV_jk = Σ_i ĝ_ik m_ij ind_ijk              ĝ = g / count if normalized
#   s_ij  = −m_ij Σ_k ĝ_ik σ_jk ind_ijk        σ = 1 unsigned, sign(V) signed
#   t_ij  = s_ij · 1[raw_ij > α] / γ
#   dq_id = Σ_j t_ij sign(q_id − k_jd),  dk_jd = −Σ_i t_ij sign(q_id − k_jd)
#
# Masked pairs are excluded by setting their Z to +inf (ind = 0).  Every
# term of a key chunk's dV and dk lies within the chunk and dq adds up over
# chunks, so the backward walks the keys in chunks and holds one
# (b, h, rows, chunk, d) cube at a time; a chunk only visits the query rows
# that attend one of its keys (under a causal mask, rows i ≥ lo).
# ---------------------------------------------------------------------------

def _chunk_rows(mask, n_q: int, n_k: int, chunk: int):
    """[(lo, hi, q_lo, q_hi)] per key chunk [lo, hi): the query rows that
    attend any of its keys under ``mask`` (one host sync)."""
    bounds = [(lo, min(lo + chunk, n_k)) for lo in range(0, n_k, chunk)]
    if mask is None:
        return [(lo, hi, 0, n_q) for lo, hi in bounds]
    live = mask
    while live.dim() > 2:
        live = live.any(0)
    live = torch.stack([live[:, lo:hi].any(-1) for lo, hi in bounds]).cpu()
    out = []
    for (lo, hi), rows in zip(bounds, live):
        idx = torch.nonzero(rows).flatten()
        q_lo, q_hi = ((int(idx[0]), int(idx[-1]) + 1) if len(idx)
                      else (0, 0))
        out.append((lo, hi, q_lo, q_hi))
    return out


def _inhibitor_core_bwd(qt, kt, vt, mask, g, *, gamma: float, shift: float,
                        signed: bool, normalize: bool, kv_chunk: int):
    """Gradients of :func:`_inhibitor_core` for the output cotangent ``g``;
    (b, h, n, d) operands, ``mask`` broadcastable to (b, h, n_q, n_k)."""
    qf, kf, vf, gf = (t.float() for t in (qt, kt, vt, g))
    n_q, n_k = qf.shape[-2], kf.shape[-2]
    if normalize:
        if mask is not None:
            cnt = mask.float().sum(-1, keepdim=True)
        else:
            cnt = torch.full((1,), float(n_k), device=qf.device)
        gf = gf / cnt.clamp(min=1.0)
    vv = vf.abs() if signed else vf
    sign_v = torch.where(vf > 0, 1.0, -1.0) if signed else None
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    inv = 1.0 / gamma
    for lo, hi, q_lo, q_hi in _chunk_rows(mask, n_q, n_k, kv_chunk):
        if q_lo >= q_hi:
            continue
        q_r, k_c = qf[..., q_lo:q_hi, :], kf[..., lo:hi, :]
        raw = torch.cdist(q_r, k_c, p=1) * inv          # (b, h, rows, c)
        z = torch.relu(raw - shift) if shift else raw
        if mask is not None:
            z = torch.where(mask[..., q_lo:q_hi, lo:hi], z, torch.inf)
        e = torch.where(vv[..., None, lo:hi, :] > z[..., None],
                        gf[..., q_lo:q_hi, None, :], 0.0)
        dv[..., lo:hi, :] = e.sum(-3)
        if signed:
            e.mul_(sign_v[..., None, lo:hi, :])
        t = e.sum(-1).mul_(-inv)
        del e
        if shift:
            t = t * (raw > shift)
        cube = q_r[..., :, None, :] - k_c[..., None, :, :]
        cube.sign_().mul_(t[..., None])
        dq[..., q_lo:q_hi, :] += cube.sum(-2)
        dk[..., lo:hi, :] = -cube.sum(-3)
    return dq.to(qt.dtype), dk.to(kt.dtype), dv.to(vt.dtype)


class _InhibitorCore(torch.autograd.Function):
    """(qt, kt, vt, mask) -> H, all (b, h, ...): the fused forward, and the
    analytic backward walking the keys in :data:`BWD_KV_CHUNK` chunks."""

    @staticmethod
    def forward(ctx, qt, kt, vt, mask, gamma, shift, signed, normalize):
        ctx.save_for_backward(qt, kt, vt, mask)
        ctx.hp = dict(gamma=gamma, shift=shift, signed=signed,
                      normalize=normalize)
        return _inhibitor_core(qt, kt, vt, mask, **ctx.hp)

    @staticmethod
    def backward(ctx, g):
        qt, kt, vt, mask = ctx.saved_tensors
        grads = _inhibitor_core_bwd(qt, kt, vt, mask, g,
                                    kv_chunk=BWD_KV_CHUNK, **ctx.hp)
        return grads + (None,) * 5


def _heads_layout(q, k, v, mask):
    """(b, n, h|h_kv, d) operands -> GQA-repeated (b, h, n, d) views and
    the mask expanded to (b, h, n_q, n_k)."""
    b, n_q, h, d = q.shape
    n_k, h_kv = k.shape[1], k.shape[2]
    k = _repeat_kv(k, h // h_kv)
    v = _repeat_kv(v, h // h_kv)
    if mask is not None:
        mask = mask.expand(b, h, n_q, n_k)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask


def inhibitor_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, mask: Optional[torch.Tensor] = None,
                        score_scale: Optional[float] = None,
                        score_shift: float = 0.5, signed: bool = True,
                        normalize: bool = True) -> torch.Tensor:
    """Multi-head inhibitor attention.

    q: (b, n_q, h, d); k, v: (b, n_k, h_kv, d) with h % h_kv == 0 (GQA).
    mask: broadcastable to (b, h, n_q, n_k), True = attend.
    Returns (b, n_q, h, d) in q.dtype.  ``normalize`` divides H by the
    count of attendable keys (a constant multiplication).  Differentiable
    through the analytic backward (:func:`inhibitor_attention_vjp`).
    """
    d = q.shape[-1]
    qt, kt, vt, mask = _heads_layout(q, k, v, mask)
    gamma = score_scale if score_scale is not None else float(d) ** 0.5
    out = _InhibitorCore.apply(qt, kt, vt, mask, float(gamma),
                               float(score_shift), bool(signed),
                               bool(normalize))
    return out.transpose(1, 2).to(q.dtype)


def inhibitor_attention_vjp(q, k, v, g, *, mask=None, score_scale=None,
                            score_shift: float = 0.5, signed: bool = True,
                            normalize: bool = True,
                            kv_chunk: int = BWD_KV_CHUNK):
    """(dq, dk, dv) of :func:`inhibitor_attention` at (q, k, v) for the
    output cotangent ``g`` (b, n_q, h, d), without running the forward:
    the analytic backward over ``kv_chunk``-key chunks."""
    b, n_q, h, d = q.shape
    n_k, h_kv = k.shape[1], k.shape[2]
    qt, kt, vt, mask = _heads_layout(q, k, v, mask)
    gamma = score_scale if score_scale is not None else float(d) ** 0.5
    dq, dk, dv = _inhibitor_core_bwd(
        qt, kt, vt, mask, g.transpose(1, 2), gamma=float(gamma),
        shift=float(score_shift), signed=bool(signed),
        normalize=bool(normalize), kv_chunk=int(kv_chunk))

    def fold(t):       # sum the GQA-repeated heads back onto their kv head
        return t.reshape(b, h_kv, h // h_kv, n_k, d).sum(2).transpose(1, 2)

    return dq.transpose(1, 2), fold(dk), fold(dv)


def inhibitor_attention_chunked(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *,
                                mask: Optional[torch.Tensor] = None,
                                score_scale: Optional[float] = None,
                                score_shift: float = 0.5, signed: bool = True,
                                normalize: bool = True,
                                kv_chunk: int = 512) -> torch.Tensor:
    """Inhibitor attention accumulated over key/value chunks.

    Inhibition is a plain sum of ReLU terms over keys (no Softmax
    normalizer), so chunked accumulation is exact: partial sums and
    counts combine by addition, with no running max or rescaling.
    Shapes as :func:`inhibitor_attention`.
    """
    b, n_q, h, d = q.shape
    n_k, h_kv = k.shape[1], k.shape[2]
    qt = q.transpose(1, 2).float()
    kt = _repeat_kv(k, h // h_kv).transpose(1, 2).float()
    vt = _repeat_kv(v, h // h_kv).transpose(1, 2).float()
    if mask is not None:
        mask = mask.expand(b, h, n_q, n_k)
    acc = torch.zeros((b, h, n_q, d), dtype=torch.float32, device=q.device)
    cnt = torch.zeros((b, h, n_q), dtype=torch.float32, device=q.device)
    for lo in range(0, n_k, kv_chunk):
        hi = min(lo + kv_chunk, n_k)
        z = manhattan_scores(qt, kt[:, :, lo:hi], score_scale=score_scale,
                             score_shift=score_shift)
        m = None if mask is None else mask[..., lo:hi]
        cnt = cnt + (float(hi - lo) if m is None else m.float().sum(-1))
        vc = vt[:, :, lo:hi]
        acc = acc + (inhibit_signed_fused(vc, z, m) if signed
                     else inhibit_fused(vc, z, m))
    if normalize:
        acc = acc / cnt[..., None].clamp(min=1.0)
    return acc.transpose(1, 2).to(q.dtype)
