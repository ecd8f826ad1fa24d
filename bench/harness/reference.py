"""The plain reference: the configuration's model in float32 PyTorch.

It follows the published description of a Llama-shaped decoder (SmolLM,
Mistral) with the paper's attention in place of Softmax, and reads its
sizes from the configuration file, never from the program:

* RMSNorm: x / sqrt(mean(x^2) + eps) * scale;
* rotary embeddings, "rotate half", at absolute positions, base
  ``rope_theta``;
* grouped-query attention: query head i reads kv head i // (h / h_kv);
* the attention the configuration names, from
  ``bench/attention/<mechanism>.py`` (the paper's inhibitor in
  ``inhibitor.py``), which refuses any value of the configuration's
  ``attention`` it does not implement;
* the gated-SiLU MLP, a tied or separate head;
* the mean token cross-entropy, and AdamW (global-norm clip, bias
  corrections, decoupled weight decay, warm-up then cosine learning
  rate), in float32.

TF32 is off while the reference runs.

``prec="fp8"`` is the control: every product's operands and the
attention's q, k, v rounded to float8 e4m3 with one scale a tensor (its
largest magnitude at 448), as a tempting lower precision would; the
gradient passes the rounding unchanged.
"""

from __future__ import annotations

import contextlib
import importlib.util
import math
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0
ATTENTION = Path(__file__).resolve().parents[1] / "attention"
# the keys of ``attention`` that the loader and ``weights.draw`` take
TAKEN = {"mechanism", "query_key_init_scale"}


@contextlib.contextmanager
def exact_float32():
    """TF32 off for products and convolutions, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def _round(x: torch.Tensor, prec: Optional[str]) -> torch.Tensor:
    if prec is None:
        return x
    if prec != "fp8":
        raise ValueError(f"unknown precision {prec!r}")
    with torch.no_grad():
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def _mm(x, w, prec):
    return _round(x, prec) @ _round(w, prec)


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, positions, base):
    """x (b, s, h, d) rotated at positions (s,)."""
    d = x.shape[-1]
    inv = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d))
    ang = positions.float()[:, None] * inv[None, :]          # (s, d/2)
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(
        "bench_attention_" + path.stem.replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def attention(model: dict) -> Callable:
    """``attend(q, k, v, attention)`` of ``bench/attention/<mechanism>.py``,
    once that module implements every value the configuration's
    ``attention`` states; a value it does not implement raises."""
    a = model["attention"]
    path = ATTENTION / f"{a['mechanism']}.py"
    if not path.is_file():
        raise ValueError(f"the reference implements no attention "
                         f"{a['mechanism']!r}: no bench/attention/"
                         f"{path.name}")
    mod = _load(path)
    off = {k: v for k, v in a.items() if k not in TAKEN | mod.READS
           and (k not in mod.HOLDS or mod.HOLDS[k] != v)}
    off.update({k: "not stated" for k in set(mod.HOLDS) | mod.READS
                if k not in a})
    if off:
        raise ValueError(f"bench/attention/{path.name} does not implement "
                         f"{off}; it holds {mod.HOLDS} and reads "
                         f"{sorted(mod.READS)}")
    return mod.attend


def _block(p: dict, model: dict, attend, x, positions, prec):
    b, s, d = x.shape
    h, hk, hd = (model["num_attention_heads"], model["num_key_value_heads"],
                 model["head_dim"])
    eps, base = model["rms_norm_eps"], model["rope_theta"]
    a = p["attn"]
    y = rmsnorm(x, p["ln1"]["scale"], eps)
    q = _mm(y, a["wq"]["kernel"].reshape(d, h * hd), prec).view(b, s, h, hd)
    k = _mm(y, a["wk"]["kernel"].reshape(d, hk * hd), prec).view(b, s, hk, hd)
    v = _mm(y, a["wv"]["kernel"].reshape(d, hk * hd), prec).view(b, s, hk, hd)
    q, k = rope(q, positions, base), rope(k, positions, base)
    o = attend(_round(q, prec), _round(k, prec), _round(v, prec),
               model["attention"])
    x = x + _mm(o.reshape(b, s, h * hd), a["wo"]["kernel"].reshape(h * hd, d),
                prec)
    y = rmsnorm(x, p["ln2"]["scale"], eps)
    f = p["ffn"]
    g = F.silu(_mm(y, f["wg"]["kernel"], prec)) * _mm(y, f["wu"]["kernel"],
                                                       prec)
    return x + _mm(g, f["wd"]["kernel"], prec)


def logits(params: dict, model: dict, tokens: torch.Tensor,
           prec: Optional[str] = None) -> torch.Tensor:
    """tokens (b, s) -> float32 logits (b, s, V), positions 0 .. s - 1."""
    x = params["embed"]["table"][tokens.long()].float()
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    attend = attention(model)
    for p in params["blocks"]:
        x = _block(p, model, attend, x, positions, prec)
    x = rmsnorm(x, params["final_norm"]["scale"], model["rms_norm_eps"])
    head = (params["embed"]["table"].t() if model["tie_word_embeddings"]
            else params["lm_head"]["kernel"])
    return _mm(x, head, prec)


def loss(params, model, tokens, labels, prec=None) -> torch.Tensor:
    lg = logits(params, model, tokens, prec)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           labels.reshape(-1).long())


def grads(loss: torch.Tensor, leaves: list) -> list:
    """d loss / d leaf; zeros for a leaf the loss does not reach (the vlm's
    patch projection on text)."""
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(leaves, got)]


# ---------------------------------------------------------------------------
# Training: AdamW as the configuration states it
# ---------------------------------------------------------------------------

def learning_rate(train: dict, step: int) -> float:
    """Warm-up to ``lr`` over ``warmup_steps``, then cosine to
    ``final_frac`` of it at ``total_steps``; ``step`` counts from 1."""
    peak, warm = train["lr"], train["warmup_steps"]
    if step < warm:
        return peak * step / warm
    prog = min(max((step - warm) / max(train["total_steps"] - warm, 1), 0.0),
               1.0)
    f = train["final_frac"]
    return peak * (f + (1 - f) * 0.5 * (1 + math.cos(math.pi * prog)))


def adamw(params: list, grads: list, mu: list, nu: list, step: int,
          train: dict) -> list:
    """One AdamW step in place; returns the clipped gradients."""
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads)).float()
    scale = torch.clamp(train["grad_clip_norm"] / norm.clamp(min=1e-12),
                        max=1.0)
    grads = [g * scale for g in grads]
    b1, b2 = train["b1"], train["b2"]
    lr = learning_rate(train, step)
    with torch.no_grad():
        for p, g, m, n in zip(params, grads, mu, nu):
            m.mul_(b1).add_(g, alpha=1 - b1)
            n.mul_(b2).add_(g.square(), alpha=1 - b2)
            upd = (m / (1 - b1 ** step)) / (
                torch.sqrt(n / (1 - b2 ** step)) + train["eps"])
            p.sub_(lr * (upd + train["weight_decay"] * p))
    return grads
