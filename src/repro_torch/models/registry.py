"""Model registry: one uniform API over the architecture families.

``get_model(cfg)`` returns a :class:`ModelApi` whose members close over
the config:

  * ``init(gen, device=None)``             -> parameter dict
  * ``forward(params, batch)``             -> logits        [prefill]
  * ``init_states(batch, max_len, **kw)``  -> decode state
  * ``step(params, tokens, states, batch)`` -> (logits, states')  [decode]
  * ``input_specs(shape)``                 -> dict of ``meta`` tensors
  * ``axes()``                             -> logical-axes tree

The dense, ``moe`` and ``hybrid`` families share the transformer branch;
``vlm`` is the same model with its patch embeddings (``batch
["image_embeds"]``, when present) prepended in the forward, and decodes
as the dense family does.  ``forward(params, batch, return_aux=True)``
returns (logits, aux): the MoE auxiliary losses summed over layers
(zeros without MoE, and for the encoder-decoder), which the training
loss adds.  The ``ssm`` branch is RWKV-6.  The ``encdec`` branch's
forward is ``forward_train(batch["frames"], batch["tokens"])``, and its
step decodes against ``batch["memory"]``, the encoder's output.

``input_specs(shape)`` describes every tensor the train / serve step of
a :class:`~repro_torch.configs.base.ShapeConfig` consumes, with the
reference's shapes and dtypes, as tensors on the ``meta`` device (no
storage).  ``axes()`` is the tree of logical axis names of ``init``'s
parameters (:mod:`repro_torch.nn.module`), one tuple per tensor, from
which :mod:`repro_torch.distributed.sharding` places them on a mesh.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec as encdec_m
from repro_torch.models import rwkv as rwkv_m
from repro_torch.models import transformer as tfm


class ModelApi(NamedTuple):
    cfg: ModelConfig
    init: Callable
    forward: Callable
    init_states: Callable
    step: Callable
    input_specs: Callable
    axes: Callable


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _lm_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"tokens": _spec((b, s), torch.int32),
                "labels": _spec((b, s), torch.int32)}
    if shape.kind == "prefill":
        return {"tokens": _spec((b, s), torch.int32)}
    # decode: one new token against a KV cache of seq_len
    return {"tokens": _spec((b, 1), torch.int32)}


def _vlm_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    specs = _lm_specs(cfg, shape)
    fe = cfg.frontend
    n_img = fe.tokens_per_item * fe.max_tiles
    if shape.kind != "decode":
        b = shape.global_batch
        specs["image_embeds"] = _spec((b, n_img, fe.embed_dim),
                                      torch.float32)
        # image tokens occupy the front of the sequence; text fills the rest
        text_len = max(shape.seq_len - n_img, 1)
        specs["tokens"] = _spec((b, text_len), torch.int32)
        if shape.kind == "train":
            specs["labels"] = _spec((b, text_len + n_img), torch.int32)
    return specs


def _encdec_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    src = min(s, cfg.encdec.max_source_len)
    frames = _spec((b, src, cfg.frontend.embed_dim), torch.float32)
    if shape.kind == "train":
        return {"frames": frames, "tokens": _spec((b, s), torch.int32),
                "labels": _spec((b, s), torch.int32)}
    if shape.kind == "prefill":
        return {"frames": frames, "tokens": _spec((b, s), torch.int32)}
    return {"memory": _spec((b, src, cfg.d_model), torch.float32),
            "tokens": _spec((b, 1), torch.int32)}


def get_model(cfg: ModelConfig) -> ModelApi:
    if cfg.family == "ssm":
        return _ssm_model(cfg)
    if cfg.family == "encdec":
        return _encdec_model(cfg)
    if cfg.family not in ("dense", "moe", "hybrid", "vlm"):
        raise ValueError(f"unknown family {cfg.family!r}")

    if cfg.family == "vlm":
        def forward(params, batch, return_aux=False):
            return tfm.lm_forward(params, cfg, batch["tokens"],
                                  extra_embeds=batch.get("image_embeds"),
                                  return_aux=return_aux)

        specs = _vlm_specs
    else:
        def forward(params, batch, return_aux=False):
            return tfm.lm_forward(params, cfg, batch["tokens"],
                                  return_aux=return_aux)

        specs = _lm_specs

    def step(params, tokens, states, batch=None):
        return tfm.lm_step(params, cfg, tokens, states)

    return ModelApi(
        cfg=cfg,
        init=lambda gen, device=None: tfm.init_lm(gen, cfg, device=device),
        forward=forward,
        init_states=lambda b, s, **kw: tfm.init_states(cfg, b, s, **kw),
        step=step,
        input_specs=lambda shape: specs(cfg, shape),
        axes=lambda: tfm.lm_axes(cfg),
    )


def _encdec_model(cfg: ModelConfig) -> ModelApi:
    def forward(params, batch, return_aux=False):
        logits = encdec_m.forward_train(params, cfg, batch["frames"],
                                        batch["tokens"])
        if not return_aux:
            return logits
        return logits, torch.zeros(2, dtype=torch.float32,
                                   device=logits.device)

    def step(params, tokens, states, batch=None):
        return encdec_m.decode_step(params, cfg, batch["memory"], tokens,
                                    states)

    return ModelApi(
        cfg=cfg,
        init=lambda gen, device=None: encdec_m.init_model(gen, cfg,
                                                          device=device),
        forward=forward,
        init_states=lambda b, s, **kw: encdec_m.init_states(cfg, b, s, **kw),
        step=step,
        input_specs=lambda shape: _encdec_specs(cfg, shape),
        axes=lambda: encdec_m.model_axes(cfg),
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
        input_specs=lambda shape: _lm_specs(cfg, shape),
        axes=lambda: rwkv_m.lm_axes(cfg),
    )
