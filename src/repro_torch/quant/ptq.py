"""Post-training quantization of a transformer onto the integer lanes.

Port of :mod:`repro.quant.ptq`.  The lane-parameterized forward runs
every layer in fixed-point integer arithmetic; this module projects a
float parameter dict into that regime, on the host in numpy float64 as
the reference does (``np.round`` rounds half to even).  Scale conventions
(all powers of two, so every rescale is a levelled shift under TFHE):

  * activations  x_int = round(x · 2^act_frac), clamped to ``act_bits``
    signed bits at every LUT domain;
  * weights      w_int = round(w · 2^weight_frac), clamped to
    ``weight_bits`` — weights stay **cleartext** in the encrypted
    setting, so projections are levelled plaintext-weight matmuls
    followed by a ``weight_frac`` right-shift back to activation scale;
  * biases       b_int = round(b · 2^(act_frac + weight_frac)) for
    linear layers (added before the shift), and activation scale for
    norm biases (added after).

Embedding rows are quantized at activation scale: the *client* embeds its
tokens locally and encrypts the embedded activations.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PtqConfig:
    """Fixed-point regime for the integer lanes (powers of two only)."""

    act_bits: int = 8        # signed activation width (LUT-domain clamp)
    act_frac: int = 6        # activations carry 2^act_frac fixed point
    weight_bits: int = 8     # signed weight width
    weight_frac: int = 6     # weights carry 2^weight_frac fixed point
    softmax_frac: int = 6    # softmax-surrogate probability precision
    exp_clip: int = 15       # exp2 LUT window (deeper logits -> p = 0)
    score_frac: int = 1      # integer logits carry 2^score_frac per unit
    ex_bits: int = 4         # half-step RMS exponent width (norm surrogate)
    sq_shift: int = 4        # squares are tabulated as x² >> sq_shift

    @property
    def act_clip(self) -> int:
        return (1 << (self.act_bits - 1)) - 1

    @property
    def weight_clip(self) -> int:
        return (1 << (self.weight_bits - 1)) - 1


def _q(x, frac: int, clip: Optional[int] = None) -> np.ndarray:
    out = np.round(np.asarray(x, np.float64) * (1 << frac)).astype(np.int64)
    if clip is not None:
        out = np.clip(out, -clip, clip)
    return out


def quantize_linear(p: dict, ptq: PtqConfig, *, fold_in=None,
                    fold_out=None) -> dict:
    """Quantize one dense layer {kernel, bias?}.  ``fold_in``/``fold_out``
    flatten multi-axis kernels (e.g. (embed, h, d)) to 2-D matmul form."""
    kern = np.asarray(p["kernel"], np.float64)
    if fold_in:
        kern = kern.reshape(-1, *kern.shape[fold_in:])
    if fold_out:
        kern = kern.reshape(*kern.shape[:fold_out], -1)
    out = {"kernel": _q(kern, ptq.weight_frac, ptq.weight_clip)}
    if "bias" in p:
        out["bias"] = _q(np.asarray(p["bias"], np.float64).reshape(-1),
                         ptq.act_frac + ptq.weight_frac)
    return out


def quantize_norm(p: dict, ptq: PtqConfig) -> dict:
    out = {"scale": _q(p["scale"], ptq.weight_frac)}
    if "bias" in p:
        out["bias"] = _q(p["bias"], ptq.act_frac)
    return out


@dataclasses.dataclass
class QuantizedLM:
    """A PTQ'd decoder-only transformer, ready for any lane.  Its arrays
    are numpy int64 on the host (cleartext weights); ``blocks`` holds one
    dict per layer."""
    cfg: Any                      # the ModelConfig it was quantized from
    ptq: PtqConfig
    embed: np.ndarray             # (vocab, d_model) int, activation scale
    blocks: List[Dict[str, Any]]
    final_norm: dict
    lm_head: dict

    @property
    def gamma_shift(self) -> int:
        a = self.cfg.attention
        gamma = (a.score_scale if a.score_scale is not None
                 else float(a.head_dim) ** 0.5)
        return max(0, int(round(math.log2(gamma)))) if gamma > 1 else 0

    @property
    def alpha_q(self) -> int:
        # the score shift α lives in activation units on integer lanes
        return max(0, int(round(self.cfg.attention.score_shift
                                * (1 << self.ptq.act_frac))))

    @property
    def scale_shift(self) -> int:
        # QKᵀ carries 2^(2·act_frac); bring logits to 2^score_frac units
        return max(0, 2 * self.ptq.act_frac + self.gamma_shift
                   - self.ptq.score_frac)


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def ptq_lm(params: dict, cfg, ptq: Optional[PtqConfig] = None) -> QuantizedLM:
    """Project a float LM parameter dict (the port's layout: ``"blocks"``
    a list of per-layer dicts, e.g. from ``params_from_jax`` or
    ``init_lm``) onto the integer regime.

    Supports the dense family with classic (non-gated) MLPs and no RoPE —
    the FHE-friendly configuration (``paper_tiny``).  Gated MLPs need a
    ciphertext×ciphertext product per hidden unit and RoPE needs
    per-position literal rotations; both are rejected loudly rather than
    silently approximated.
    """
    ptq = ptq or PtqConfig()
    moe = getattr(cfg, "moe", None)
    if cfg.family != "dense" or moe is not None:
        raise ValueError(f"lane PTQ supports the dense family; got "
                         f"{cfg.family!r} (moe={moe is not None})")
    if cfg.mlp == "gated_silu":
        raise ValueError(
            "gated MLPs multiply two ciphertext activations per hidden "
            "unit (cipher×cipher); use mlp_relu/mlp_gelu for integer lanes")
    if cfg.attention.use_rope:
        raise ValueError("RoPE is not supported on integer lanes; "
                         "use_rope=False (paper_tiny) is the FHE setting")
    if cfg.tie_embeddings:
        raise ValueError("tied embeddings would reuse the activation-scale "
                         "table as logit weights; untie for lane PTQ")

    host = _to_host(params)
    blocks = []
    for bp in host["blocks"][:cfg.num_layers]:
        blocks.append({
            "ln1": quantize_norm(bp["ln1"], ptq),
            "wq": quantize_linear(bp["attn"]["wq"], ptq, fold_out=1),
            "wk": quantize_linear(bp["attn"]["wk"], ptq, fold_out=1),
            "wv": quantize_linear(bp["attn"]["wv"], ptq, fold_out=1),
            "wo": quantize_linear(bp["attn"]["wo"], ptq, fold_in=2),
            "ln2": quantize_norm(bp["ln2"], ptq),
            "wi": quantize_linear(bp["ffn"]["wi"], ptq),
            "wo_mlp": quantize_linear(bp["ffn"]["wo"], ptq),
        })
    return QuantizedLM(
        cfg=cfg, ptq=ptq,
        embed=_q(host["embed"]["table"], ptq.act_frac, ptq.act_clip),
        blocks=blocks,
        final_norm=quantize_norm(host["final_norm"], ptq),
        lm_head=quantize_linear(host["lm_head"], ptq),
    )
