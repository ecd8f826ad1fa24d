"""The plain reference: the configuration's model in float32 PyTorch.

The model is its family's (``bench/families/<family>.py``, found by
``harness.families``), which reads its sizes from the configuration file,
never from the program.  Here is what every family shares:

* the attention the configuration names, from
  ``bench/attention/<mechanism>.py`` (the paper's inhibitor in
  ``inhibitor.py``), which refuses any value of the configuration's
  ``attention`` it does not implement;
* RMSNorm and rotary embeddings ("rotate half", at absolute positions);
* the parameters spread over a list of devices, a layer to a device, with
  no collective (``spread``);
* the gradients, and AdamW (global-norm clip, bias corrections, decoupled
  weight decay, warm-up then cosine learning rate), in float32.

TF32 is off while the reference runs.

``prec="fp8"`` is the control: every product's operands and the
attention's q, k, v rounded to float8 e4m3 with one scale a tensor (its
largest magnitude at 448), as a tempting lower precision would; the
gradient passes the rounding unchanged.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import torch

from harness import cell, families

FP8_MAX = 448.0
ATTENTION = cell.ROOT / "bench" / "attention"
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


def attention(model: dict) -> Callable:
    """``attend(q, k, v, attention)`` of ``bench/attention/<mechanism>.py``,
    once that module implements every value the configuration's
    ``attention`` states; a value it does not implement raises."""
    a = model["attention"]
    mod = cell.module(ATTENTION / f"{a['mechanism']}.py")
    if mod is None:
        raise ValueError(f"the reference implements no attention "
                         f"{a['mechanism']!r}: no bench/attention/"
                         f"{a['mechanism']}.py")
    off = {k: v for k, v in a.items() if k not in TAKEN | mod.READS
           and (k not in mod.HOLDS or mod.HOLDS[k] != v)}
    off.update({k: "not stated" for k in set(mod.HOLDS) | mod.READS
                if k not in a})
    if off:
        raise ValueError(f"bench/attention/{a['mechanism']}.py does not "
                         f"implement {off}; it holds {mod.HOLDS} and reads "
                         f"{sorted(mod.READS)}")
    return mod.attend


def device_of(tree) -> torch.device:
    """The device of a parameter tree's first leaf."""
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree.device


def spread(params: dict, devices: list) -> dict:
    """Autograd leaves copied from ``params`` by ``.to()``, with no
    collective: of each list of layers (``blocks``, wherever it lies), layer
    i on ``devices[i * len(devices) // layers]``; every other leaf on the
    first device.  One device gives a copy of the tree on it."""
    def walk(node, dev, key=None):
        if isinstance(node, dict):
            return {k: walk(v, dev, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            n = len(node)
            return [walk(v, devices[i * len(devices) // n]
                         if key == "blocks" else dev)
                    for i, v in enumerate(node)]
        return node.detach().to(dev, copy=True).requires_grad_(True)

    return walk(params, devices[0])


def logits(params: dict, model: dict, tokens: torch.Tensor,
           prec: Optional[str] = None) -> torch.Tensor:
    """tokens (b, s) -> float32 logits (b, s, V) of the configuration's
    family, positions 0 .. s - 1."""
    return families.of(model).logits(params, model, tokens, prec)


def loss(params, model, tokens, labels, prec=None) -> torch.Tensor:
    """The mean token cross-entropy of the configuration's family."""
    return families.of(model).loss(params, model, tokens, labels, prec)


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
    first = grads[0].device
    norm = torch.sqrt(sum(g.double().square().sum().to(first)
                          for g in grads)).float()
    scale = torch.clamp(train["grad_clip_norm"] / norm.clamp(min=1e-12),
                        max=1.0)
    grads = [g * scale.to(g.device) for g in grads]
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
