"""AdamW optimizer over nested parameter dicts.

Port of :mod:`repro.optim.adamw`, with the reference's order of
operations: clip by the global norm, ``step + 1``, bias corrections in
float32, the decoupled weight decay added to the update, all arithmetic
in float32 whatever the parameter and moment dtypes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float | Callable = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: Optional[float] = 1.0
    # moments dtype: fp32 is the safe default; bf16 halves optimizer memory
    moment_dtype: str = "float32"


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32, on the parameters' device
    mu: Any
    nu: Any


def init_adamw(params, cfg: AdamWConfig) -> AdamWState:
    mdt = _DTYPES[cfg.moment_dtype]

    def zeros(x):
        return torch.zeros(x.shape, device=x.device,
                           dtype=mdt if x.is_floating_point() else x.dtype)

    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def _lr_at(cfg: AdamWConfig, step):
    if callable(cfg.lr):
        return cfg.lr(step)
    return cfg.lr


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig):
    """One AdamW step.  Returns (params, new_state, metrics).

    Runs in place under ``torch.no_grad()``: the parameter and moment
    tensors of ``params`` and ``state`` are overwritten with their new
    values (the reference returns new arrays), so ``params`` and the
    returned parameters are the same tree.  The update is computed in
    float32 and stored back in each tensor's own dtype."""
    metrics = {}
    if cfg.grad_clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip_norm)
        metrics["grad_norm"] = gnorm
    step = state.step + 1
    lr = _lr_at(cfg, step)
    metrics["lr"] = lr
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)
    for g, m, n, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                          tree_leaves(state.nu), tree_leaves(params)):
        gf = g.float()
        m32 = m.float() * b1 + gf * (1 - b1)
        n32 = n.float() * b2 + torch.square(gf) * (1 - b2)
        mhat = m32 / bc1
        nhat = n32 / bc2
        delta = mhat / (torch.sqrt(nhat) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        n.copy_(n32)
    return params, AdamWState(step, state.mu, state.nu), metrics
