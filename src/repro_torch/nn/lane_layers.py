"""Lane-generic nn layers: norm surrogate, linear, MLP, embedding, logits.

Port of :mod:`repro.nn.lane_layers`.  Every layer here is written once
against the :class:`repro_torch.core.lanes.Lane` op set — add/sub,
plaintext-weight matmul, literal mul/shift, ReLU/abs, univariate LUT — so
the same code runs the float reference, the integer arm, and the TFHE
cost simulator.  LUT sites carry their real-valued counterpart
(``float_fn``, over torch tensors), which is the *only* place the float
lane diverges from the integer pipeline.

The norm surrogate is the one FHE-shaped deviation: dynamic normalization
``x · rsqrt(ms(x))`` is a ciphertext×ciphertext product, which would
destroy the inhibitor block's zero-cmul property.  Instead a LUT maps the
mean square to its dyadic reciprocal-sqrt exponent ``ex ≈ log2(rms)``
(a few bits), and a packed bivariate LUT applies the data-dependent
shift ``x · 2^(act_frac − ex)`` in one PBS.
"""

from __future__ import annotations

from math import pi, sqrt

import numpy as np
import torch

from repro_torch.core.lanes import Lane, reciprocal_literal
from repro_torch.quant.ptq import PtqConfig

_MEAN_FRAC = 8   # significant bits of the 1/d literals in mean reductions


def _mean_literal(d: int):
    """1/d with ~_MEAN_FRAC significant bits for *any* d."""
    return reciprocal_literal(d, base_bits=_MEAN_FRAC)


def lane_linear(lane: Lane, x, p: dict, *, ptq: PtqConfig):
    """x @ W_cleartext (+ bias) >> weight_frac — scale-preserving."""
    y = lane.matmul_plain(x, np.asarray(p["kernel"]))
    if "bias" in p:
        y = lane.add(y, np.asarray(p["bias"]))
    return lane.shift_right(y, ptq.weight_frac)


def lane_norm(lane: Lane, x, p: dict, *, ptq: PtqConfig,
              subtract_mean: bool = False):
    """RMSNorm/LayerNorm surrogate: shift-normalized, LUT reciprocal-sqrt.

    1. (LayerNorm only) subtract the mean — levelled literal ops.
    2. squares via LUT ``t → t² >> sq_shift`` (input saturates to the
       activation clamp), mean via literal 1/d.
    3. the reciprocal-sqrt LUT maps the mean square to its dyadic
       exponent in *half steps* ``ex = round(2·log2 rms) ∈ [0, 2^ex_bits)``.
    4. packed bivariate LUT applies ``x · 2^(act_frac − ex/2)`` — one PBS
       at ``act_bits + ex_bits`` width.
    5. learned scale (weight-scale literal) and bias (activation scale).
    """
    A, B = ptq.act_frac, ptq.act_clip
    sq_shift, ex_hi = ptq.sq_shift, (1 << ptq.ex_bits) - 1
    d = lane.shape(x)[-1]
    c_d, f_d = _mean_literal(d)

    if subtract_mean:
        mu = lane.shift_right(
            lane.mul_literal(lane.sum(x, axis=-1, keepdims=True), c_d),
            f_d)
        x = lane.sub(x, mu)

    sq = lane.lut(
        x, lambda t: (t * t) >> sq_shift, -B, B,
        float_fn=lambda t: t * t / float(1 << sq_shift))
    ms = lane.shift_right(
        lane.mul_literal(lane.sum(sq, axis=-1, keepdims=True), c_d),
        f_d)

    ms_hi = (B * B) >> sq_shift

    def _ex_int(m):
        rms = np.sqrt(np.maximum(m, 1).astype(np.float64)
                      * (1 << sq_shift))
        return np.clip(np.round(2.0 * np.log2(rms)), 0, ex_hi).astype(
            np.int64)

    ex = lane.lut(
        ms, _ex_int, 0, ms_hi,
        float_fn=lambda m: _fclip(2.0 * _flog2_rms(m, sq_shift), ex_hi,
                                  lo=0))

    def _shift_int(t, e):
        return np.clip(
            np.round(t.astype(np.float64) * 2.0 ** (A - e / 2.0)),
            -B, B).astype(np.int64)

    y = lane.lut2(
        x, ex, _shift_int, x_lo=-B, x_hi=B, y_lo=0, y_hi=ex_hi,
        float_fn=lambda t, e: _fclip(t * 2.0 ** (A - e / 2.0), B))

    y = lane.shift_right(lane.mul_literal(y, np.asarray(p["scale"])),
                         ptq.weight_frac)
    if "bias" in p:
        y = lane.add(y, np.asarray(p["bias"]))
    return y


def _flog2_rms(m, sq_shift):
    return 0.5 * torch.log2(torch.clamp_min(m, 1e-6) * float(1 << sq_shift))


def _fclip(t, b, lo=None):
    return torch.clamp(t, -float(b) if lo is None else float(lo), float(b))


def _gelu(x, xp):
    """tanh-approximation GELU over either array module (numpy table
    builds and the torch float lane share one formula)."""
    return 0.5 * x * (1.0 + xp.tanh(sqrt(2.0 / pi)
                                    * (x + 0.044715 * x ** 3)))


def lane_mlp(lane: Lane, x, wi: dict, wo: dict, *, ptq: PtqConfig,
             activation: str = "relu"):
    """Classic two-layer MLP (paper eq. 4): act(x W1 + b1) W2 + b2.
    ReLU is the native 1-PBS op; GELU is a LUT over the activation
    domain.  Gated variants are rejected at PTQ time (cipher×cipher)."""
    h = lane_linear(lane, x, wi, ptq=ptq)
    if activation == "relu":
        h = lane.relu(h)
    elif activation == "gelu":
        A, B = ptq.act_frac, ptq.act_clip
        h = lane.lut(
            h,
            lambda t: np.round(_gelu(t.astype(np.float64) / (1 << A), np)
                               * (1 << A)).astype(np.int64),
            -4 * B, 4 * B,
            float_fn=lambda t: _gelu(t / float(1 << A), torch)
            * float(1 << A))
    else:
        raise ValueError(f"unsupported lane activation {activation!r}")
    return lane_linear(lane, h, wo, ptq=ptq)


def lane_embed(lane: Lane, table_q: np.ndarray, tokens):
    """Client-side embedding: cleartext table lookup on cleartext tokens,
    then ingestion into the lane (encryption on ``fhe_sim``).  A TFHE
    server cannot index a table with an encrypted id, so in the paper's
    deployment the client embeds locally and encrypts activations."""
    return lane.embed(table_q, tokens)


def lane_logits(lane: Lane, x, final_norm: dict, lm_head: dict, *,
                ptq: PtqConfig, subtract_mean: bool = False):
    """Final norm + cleartext lm-head projection → encrypted logits
    (decrypted and argmax'd client-side)."""
    h = lane_norm(lane, x, final_norm, ptq=ptq,
                  subtract_mean=subtract_mean)
    return lane_linear(lane, h, lm_head, ptq=ptq)
