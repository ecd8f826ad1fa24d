"""Model registry: one uniform API over the architecture families.

``get_model(cfg)`` returns a :class:`ModelApi` whose members close over
the config:

  * ``init(gen, device=None)``             -> parameter dict
  * ``forward(params, batch)``             -> logits        [prefill]
  * ``init_states(batch, max_len, **kw)``  -> decode state
  * ``step(params, tokens, states, batch)`` -> (logits, states')  [decode]

The dense, ``moe`` and ``hybrid`` families share the transformer branch;
their ``forward(params, batch, return_aux=True)`` returns (logits, aux),
the MoE auxiliary losses summed over layers (zeros without MoE), which
the training loss adds.  The ``ssm`` branch is RWKV-6.  The
encoder-decoder and vlm families raise ``NotImplementedError`` naming
their ROADMAP item, [5c].
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rwkv as rwkv_m
from repro_torch.models import transformer as tfm


class ModelApi(NamedTuple):
    cfg: ModelConfig
    init: Callable
    forward: Callable
    init_states: Callable
    step: Callable


#: the reference's families the port does not run yet
NOT_PORTED_FAMILIES = ("encdec", "vlm")


def get_model(cfg: ModelConfig) -> ModelApi:
    if cfg.family == "ssm":
        return _ssm_model(cfg)
    if cfg.family in NOT_PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to PyTorch yet (ROADMAP "
            f"queue 1 item [5c])")
    if cfg.family not in ("dense", "moe", "hybrid"):
        raise ValueError(f"unknown family {cfg.family!r}")

    def forward(params, batch, return_aux=False):
        return tfm.lm_forward(params, cfg, batch["tokens"],
                              return_aux=return_aux)

    def step(params, tokens, states, batch=None):
        return tfm.lm_step(params, cfg, tokens, states)

    return ModelApi(
        cfg=cfg,
        init=lambda gen, device=None: tfm.init_lm(gen, cfg, device=device),
        forward=forward,
        init_states=lambda b, s, **kw: tfm.init_states(cfg, b, s, **kw),
        step=step,
    )


def _ssm_model(cfg: ModelConfig) -> ModelApi:
    from repro_torch.core.mechanism import kernel_native

    def forward(params, batch):
        # the WKV kernel where the tokens live on a platform it runs
        # natively on (a CUDA card); the exact scan elsewhere (the CPU),
        # as the reference takes its kernel on the TPU only
        tokens = batch["tokens"]
        return rwkv_m.lm_forward(
            params, cfg, tokens,
            use_kernel=kernel_native("wkv6", tokens.device.type))

    def step(params, tokens, states, batch=None):
        return rwkv_m.lm_step(params, cfg, tokens, states)

    return ModelApi(
        cfg=cfg,
        init=lambda gen, device=None: rwkv_m.init_lm(gen, cfg, device=device),
        forward=forward,
        init_states=lambda b, s, **kw: rwkv_m.init_states(cfg, b, s, **kw),
        step=step,
    )
