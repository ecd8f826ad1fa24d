"""Both attention mechanisms as TFHE circuits — lane dispatches.

Port of :mod:`repro.fhe.circuits`.  The circuit *is* the lane-generic
mechanism from :mod:`repro_torch.quant.int_attention` executed on a
:class:`~repro_torch.core.lanes.FheSimLane` — one algorithm shared with
the plaintext int arm, bit-exact by construction — and these wrappers
keep the (T, d)-per-head numpy signature of the paper's Table 2/4
experiments.  Each returns the exact integer result (numpy) plus the
circuit's cost summary.  The circuit runs on ``ctx``'s device (a new
context's: the card).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.fhe.tfhe_sim import FheContext

# NOTE: the lane machinery is imported inside the wrappers — importing it
# here would initialise repro_torch.core, whose mechanism registration
# imports this module.


def inhibitor_attention_circuit(
    q: np.ndarray,     # (T, d) int
    k: np.ndarray,     # (T, d) int
    v: np.ndarray,     # (T, d) int
    *,
    gamma_shift: int = 0,
    alpha_q: int = 0,
    signed: bool = False,
    ctx: Optional[FheContext] = None,
) -> Tuple[np.ndarray, dict]:
    """Encrypted Inhibitor attention (paper eq. 5 + 6/7, integer form).

    PBS inventory per (T, d) single head:
      * scores:     T²·d  abs-LUTs  (+ T² shift-ReLU LUTs when α > 0)
      * inhibition: T²·d  ReLU-LUTs  (doubled when ``signed``)
    No ciphertext multiplications at all — additions are levelled.
    """
    from repro_torch.core.lanes import FheSimLane
    from repro_torch.quant.int_attention import lane_inhibitor_attention

    lane = FheSimLane(ctx)
    h = lane_inhibitor_attention(
        lane, lane.array(q), lane.array(k), lane.array(v),
        gamma_shift=gamma_shift, alpha_q=alpha_q, signed=signed)
    return lane.to_numpy(h), lane.ctx.summary()


def dotprod_attention_circuit(
    q: np.ndarray,
    k: np.ndarray,
    v: np.ndarray,
    *,
    scale_shift: int = 0,
    softmax_frac_bits: int = 4,
    ctx: Optional[FheContext] = None,
) -> Tuple[np.ndarray, dict]:
    """Encrypted dot-product attention (paper's baseline arm).

    PBS inventory per (T, d) single head:
      * QKᵀ:      2·T²·d  (cipher muls, 2 PBS each)
      * softmax:  T²  max-tree + T² exp-LUTs + T² cipher muls with the
                  reciprocal (2 PBS each) + T reciprocal LUTs
      * S·V:      2·T²·d  (cipher muls)
    ≈ 4·T²·d + 5·T² PBS — about twice the inhibitor, with wider messages.
    The exp window is clipped to [−15, 0].
    """
    from repro_torch.core.lanes import FheSimLane
    from repro_torch.quant.int_attention import lane_dot_product_attention

    lane = FheSimLane(ctx)
    h = lane_dot_product_attention(
        lane, lane.array(q), lane.array(k), lane.array(v),
        scale_shift=scale_shift, frac_bits=softmax_frac_bits, exp_clip=15)
    return lane.to_numpy(h), lane.ctx.summary()
