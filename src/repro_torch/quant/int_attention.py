"""Integer-arithmetic attention, written once against the lane op set.

Port of :mod:`repro.quant.int_attention`.  Both mechanisms are
*lane-generic* functions (:func:`lane_inhibitor_attention`,
:func:`lane_dot_product_attention`) over :mod:`repro_torch.core.lanes`:
run them on the ``int`` lane and you get the paper's plaintext integer
scaling arm (torch int32); run them on the ``fhe_sim`` lane and the
*same* code is the TFHE circuit with PBS/bit-width accounting — bit-exact
with the int lane by construction.  :func:`int_inhibitor_attention` and
:func:`int_dot_product_attention` are thin int-lane wrappers on the
inputs' device.

  * inhibitor: |q − k| sums (add/abs), shift/ReLU, value inhibition
    (sub/ReLU) — *no ciphertext×ciphertext products at all*.
  * dot-product: cipher–cipher MACs for QKᵀ and S·V plus the integer
    Softmax surrogate (max-subtract, exp2 LUT on the clamped difference,
    reciprocal LUT of the row sum multiplied back as one more cipher–
    cipher product).

Fixed-point range discipline: with ``p ≤ denom`` and ``recip ≤
2^{2·frac_bits}``, every product here is bounded by ``2^{2·frac_bits +
1}`` and the S·V accumulation by ``2^{frac_bits}·max|V|``, independent of
``n_k``; ``frac_bits`` is capped at 12 to keep int32 headroom.

Masking is cleartext (attention structure is public): masked pairs are
excluded from the combining sums, so a fully masked row yields zero.
Masks may be numpy or torch bool arrays; the lanes move them to their
device.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Tuple

import numpy as np
import torch

from repro_torch.quant.fake_quant import QuantConfig, compute_scale, quantize

# the lanes are imported lazily: repro_torch.core's mechanism registration
# imports this module
if TYPE_CHECKING:
    from repro_torch.core.lanes import IntLane, Lane
else:
    Lane = "Lane"

_COUNT_FRAC = 8     # fixed-point bits for the key-count normalization


def quantize_qkv(q, k, v, bits: int = 8) -> Tuple:
    """Shared-scale symmetric quantization of q, k, v (paper setup)."""
    cfg = QuantConfig(bits=bits)
    s = torch.maximum(compute_scale(q, cfg),
                      torch.maximum(compute_scale(k, cfg),
                                    compute_scale(v, cfg)))
    return (quantize(q, s, cfg), quantize(k, s, cfg), quantize(v, s, cfg),
            s)


def _count_literal(mask, n_k: int, frac_base: int):
    """Cleartext attendable-key-count reciprocal as an adaptive fixed-
    point literal (the mask is public, so this is a literal multiply).
    Since the inhibition sum is bounded by ``cnt·max|V|``, the rescaled
    product stays under ``2^frac·max|V|`` independent of the count."""
    from repro_torch.core.lanes import reciprocal_literal

    if mask is None:
        return reciprocal_literal(n_k, base_bits=frac_base)
    return reciprocal_literal(n_k, count=mask.sum(-1).clip(1),
                              base_bits=frac_base)


# ---------------------------------------------------------------------------
# Lane-generic mechanisms: q (..., n_q, d); k, v (..., n_k, d);
# mask — cleartext bool, broadcastable to (..., n_q, n_k)
# ---------------------------------------------------------------------------

def lane_inhibitor_attention(
    lane: Lane,
    q, k, v,
    *,
    gamma_shift: int = 0,     # score scale as a right-shift (γ = 2^shift)
    alpha_q: int = 0,         # quantized score shift α (integer units)
    signed: bool = False,     # eq. 7 (signed) vs eq. 6 (unsigned)
    mask=None,
    normalize: bool = False,
):
    """Inhibitor attention on any lane (paper eq. 5 + 6/7, integer form).

    Z = (Σ|q−k|) >> gamma_shift; H = Σ_j (V − Z)⁺ [− (−V − Z)⁺ if signed],
    masked pairs excluded.  Ops: sub, abs, add, shift, ReLU — zero
    ciphertext×ciphertext products, which is the paper's whole point.
    """
    qe = lane.expand_dims(q, -2)                       # (..., n_q, 1, d)
    ke = lane.expand_dims(k, -3)                       # (..., 1, n_k, d)
    z = lane.sum(lane.abs(lane.sub(qe, ke)), axis=-1)  # (..., n_q, n_k)
    if gamma_shift:
        z = lane.shift_right(z, gamma_shift)
    if alpha_q:
        z = lane.relu(lane.sub(z, alpha_q))

    ve = lane.expand_dims(v, -3)                       # (..., 1, n_k, d)
    ze = lane.expand_dims(z, -1)                       # (..., n_q, n_k, 1)
    inh = lane.relu(lane.sub(ve, ze))
    if signed:
        inh = lane.sub(inh, lane.relu(lane.sub(lane.neg(ve), ze)))
    if mask is not None:
        inh = lane.select(mask[..., None], inh, 0)
    h = lane.sum(inh, axis=-2)                         # (..., n_q, d)
    if normalize:
        c, f = _count_literal(mask, lane.shape(k)[-2], _COUNT_FRAC)
        c = c if mask is None else c[..., None]
        # two-step rescale: pre-shifting h keeps the literal product
        # under 2^16·max|V| regardless of n_k; the truncation it adds is
        # ≤ 2^(f-16)/cnt output units
        pre = max(0, f - 16)
        if pre:
            h = lane.shift_right(h, pre)
        h = lane.shift_right(lane.mul_literal(h, c), f - pre)
    return h


def lane_dot_product_attention(
    lane: Lane,
    q, k, v,
    *,
    scale_shift: int = 0,
    frac_bits: int = 8,
    exp_clip: int = 15,
    mask=None,
    normalize: bool = False,   # softmax already normalizes; kept for symmetry
):
    """Dot-product attention on any lane (the paper's comparison arm).

    QKᵀ cipher MACs → shift scale → integer softmax surrogate (max via the
    relu-tree over the attendable subset, exp2 LUT over the clamped
    difference, reciprocal LUT of the row sum multiplied back) →
    fixed-point S·V.
    """
    del normalize
    if frac_bits > 12:
        raise ValueError(
            f"frac_bits={frac_bits} > 12: fixed-point products reach "
            "2^(2*frac_bits+1) and would overflow 32-bit integer lanes")
    fb = frac_bits
    s = lane.dot_scores(q, k)                          # (..., n_q, n_k)
    if scale_shift:
        s = lane.shift_right(s, scale_shift)

    if mask is not None:
        m = lane.masked_max(s, mask, axis=-1, keepdims=True)
    else:
        m = lane.max(s, axis=-1, keepdims=True)
    d = lane.sub(s, m)
    p = lane.lut(
        d,
        lambda x: (np.exp2(x.astype(np.float64)) * (1 << fb)).astype(
            np.int64),
        -exp_clip, 0,
        float_fn=lambda t: torch.exp2(t) * float(1 << fb))
    if mask is not None:
        p = lane.select(mask, p, 0)                    # excluded, not -inf
    denom = lane.sum(p, axis=-1, keepdims=True)
    n_k = lane.shape(k)[-2]
    recip = lane.lut(
        denom,
        lambda x: (1 << (2 * fb)) // np.maximum(x, 1),
        0, int(n_k) << fb,
        float_fn=lambda x: float(1 << (2 * fb)) / torch.clamp_min(x, 1e-6),
        # the int lane divides instead of building an n_k·2^fb table;
        # both operands are positive, so floor and truncation agree
        int_fn=lambda x: (1 << (2 * fb)) // torch.clamp_min(x, 1))
    pr = lane.shift_right(lane.mul(p, recip), fb)      # probs, fb frac bits
    out = lane.mix_values(pr, v)
    return lane.shift_right(out, fb)


def lane_attention_heads(lane: Lane, lane_fn, q, k, v, *, mask=None, **kw):
    """Adapt the uniform (b, n, h|h_kv, d) layout to the per-head lane
    mechanisms: GQA-repeat kv heads, run at (b, h, n, d), restore layout.
    ``mask`` (cleartext, (b|1, 1, n_q, n_k)) broadcasts over heads."""
    rep = lane.shape(q)[2] // lane.shape(k)[2]
    qt = lane.transpose(q, (0, 2, 1, 3))
    kt = lane.transpose(lane.repeat(k, rep, 2) if rep > 1 else k,
                        (0, 2, 1, 3))
    vt = lane.transpose(lane.repeat(v, rep, 2) if rep > 1 else v,
                        (0, 2, 1, 3))
    out = lane_fn(lane, qt, kt, vt, mask=mask, **kw)
    return lane.transpose(out, (0, 2, 1, 3))


# ---------------------------------------------------------------------------
# int32 entry points (thin int-lane wrappers on the inputs' device)
# ---------------------------------------------------------------------------

def _int_lane(x) -> "IntLane":
    from repro_torch.core.lanes import IntLane

    return IntLane(device=x.device if isinstance(x, torch.Tensor) else None)


def int_inhibitor_attention(
    qi: torch.Tensor,        # (..., n_q, d) int32
    ki: torch.Tensor,        # (..., n_k, d) int32
    vi: torch.Tensor,        # (..., n_k, d) int32
    *,
    gamma_shift: int = 0,
    alpha_q: int = 0,
    signed: bool = False,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Integer inhibitor attention (eq. 5/6/7 on int32 lanes)."""
    lane = _int_lane(qi)
    return lane_inhibitor_attention(
        lane, lane.array(qi), lane.array(ki), lane.array(vi),
        gamma_shift=gamma_shift, alpha_q=alpha_q, signed=signed, mask=mask)


def int_dot_product_attention(
    qi: torch.Tensor,
    ki: torch.Tensor,
    vi: torch.Tensor,
    *,
    scale_shift: int = 0,
    mask: Optional[torch.Tensor] = None,
    frac_bits: int = 8,
) -> torch.Tensor:
    """Integer dot-product attention baseline (paper's comparison arm)."""
    lane = _int_lane(qi)
    return lane_dot_product_attention(
        lane, lane.array(qi), lane.array(ki), lane.array(vi),
        scale_shift=scale_shift, frac_bits=frac_bits, mask=mask)
