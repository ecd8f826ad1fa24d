"""RWKV-6 (Finch) language model: the attention-free ``ssm`` family.

Port of :mod:`repro.models.rwkv`.  The paper's inhibitor replaces
dot-product attention; RWKV has none, so this family runs without it.
Parameters are a dict whose ``"blocks"`` entry is a list of per-layer
dicts (the reference stacks them and scans); the forward is a Python
loop over the layers.  Block (pre-norm)::

    x = x + time_mix(ln1(x))        # the WKV token mixer
    x = x + channel_mix(ln2(x))     # squared-ReLU FFN with token shift

The WKV's kernel-vs-scan choice is an explicit plan
(:func:`repro_torch.core.mechanism.choose_plan`, trace-logged like the
attention planner's): the chunked kernel (``"pallas"``, the reference's
name for its kernel backend) for training and prefill from a zero state,
the exact scan (``"naive"``) for a carried decode state or when the
caller turns the kernel off.  In training (grad mode, no state)
``cfg.remat`` "full" or "dots" wraps each block in
``torch.utils.checkpoint``, as the dense family does: the block's
forward, the WKV kernel included, runs again in the backward.

Decode state (:class:`RwkvLayerState`) is O(1) in the sequence length:
per layer the (b, h, n, n) WKV state and the last token each mixer saw,
stacked on a leading layer axis.

Under the sharded steps every layer handed as a
:class:`~repro_torch.distributed.sharding.ModelShards` computes
tensor-parallel over ``model`` (:mod:`repro_torch.nn.ssm`): the
embedding and the logits head their vocabulary rows, the time-mix its
h/M heads (the WKV kernel on them, its per-head ``embed`` leaves sliced
to them), the channel-mix its slice of the hidden width; a time-mix whose
heads do not divide over ``model`` computes whole.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (
    at_positions, constrain, enter_seq, into_region, model_size,
    own_positions, seq_parallel, seq_parallel_on, seq_split)
from repro_torch.nn import embedding as emb
from repro_torch.nn import norm as normnn
from repro_torch.nn import ssm as ssmnn
from repro_torch.nn.linear import apply_dense, dense_axes, init_dense


class RwkvLayerState(NamedTuple):
    wkv: torch.Tensor        # (L, b, h, n, n) float32 WKV state
    tm_x: torch.Tensor       # (L, b, d) last token seen by the time-mix
    cm_x: torch.Tensor       # (L, b, d) last token seen by the channel-mix


def _num_heads(cfg: ModelConfig) -> int:
    return cfg.attention.num_heads


def _layernorm(p, x, *, eps):
    """A layer norm of the residual stream (at the rank's positions of a
    sequence-parallel stream: :func:`at_positions`)."""
    return normnn.apply_layernorm({k: at_positions(v) for k, v in p.items()},
                                  x, eps=eps)


def init_block(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    kw = dict(dtype=cfg.pdtype, device=device)
    return {
        "ln1": normnn.init_layernorm(cfg.d_model, **kw),
        "time_mix": ssmnn.init_rwkv6_timemix(
            gen, cfg.d_model, _num_heads(cfg), lora_dim=cfg.ssm.lora_dim,
            decay_lora_dim=cfg.ssm.decay_lora_dim, **kw),
        "ln2": normnn.init_layernorm(cfg.d_model, **kw),
        "channel_mix": ssmnn.init_rwkv6_channelmix(
            gen, cfg.d_model, cfg.d_ff, **kw),
    }


def block_axes(cfg: ModelConfig) -> dict:
    """Logical axes of :func:`init_block`'s tree."""
    return {"ln1": normnn.layernorm_axes(),
            "time_mix": ssmnn.rwkv6_timemix_axes(),
            "ln2": normnn.layernorm_axes(),
            "channel_mix": ssmnn.rwkv6_channelmix_axes()}


def wkv_plan(use_kernel: bool, carried_state: bool):
    """The WKV token mixer's plan: the chunked kernel (``"pallas"``) from
    a zero state when the caller allows it, else the exact scan
    (``"naive"``)."""
    from repro_torch.core.mechanism import choose_plan

    return choose_plan("wkv6", [
        ("pallas", use_kernel and not carried_state,
         "chunked WKV kernel (train/prefill, zero initial state)"),
        ("naive", True,
         "exact scan (decode state carry or kernel disabled)"),
    ])


def apply_block(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
                state: Optional[tuple] = None, use_kernel: bool = True):
    """One layer.  ``state`` is that layer's (wkv, tm_x, cm_x) or None
    (a zero state).  Returns (x, (wkv', tm_x', cm_x'))."""
    cdt = cfg.cdtype
    n = x.shape[1]          # the residual's positions: s/M under SP
    h = _layernorm(params["ln1"], x, eps=cfg.norm_eps)
    h = constrain(h, "batch", "seq_sp", "embed")
    plan = wkv_plan(use_kernel, state is not None)
    # the token shift and the WKV scan need the whole sequence; the
    # ddlerp mix is computed alike on every rank, so the gather's
    # backward takes the rank's own positions (enter_seq)
    a, (wkv_state, tm_x) = ssmnn.apply_rwkv6_timemix(
        params["time_mix"], enter_seq(h, summed=False), _num_heads(cfg),
        state=None if state is None else state[0],
        x_prev=None if state is None else state[1],
        use_kernel=plan.backend == "pallas", compute_dtype=cdt)
    x = x + own_positions(a, n)
    h2 = _layernorm(params["ln2"], x, eps=cfg.norm_eps)
    f, cm_x = ssmnn.apply_rwkv6_channelmix(
        params["channel_mix"], enter_seq(h2, summed=False),
        x_prev=None if state is None else state[2], compute_dtype=cdt)
    x = constrain(x + own_positions(f, n), "batch", "seq_sp", "embed")
    return x, (wkv_state, tm_x, cm_x)


def init_lm(gen: torch.Generator, cfg: ModelConfig, *, device=None) -> dict:
    """Random parameters from ``gen`` (on the CPU, or on ``device``: see
    :mod:`repro_torch.nn.init`), on ``device`` (default ``cuda``; raises
    when no card is present)."""
    dev = resolve_device(device)
    kw = dict(dtype=cfg.pdtype, device=dev)
    p = {
        "embed": emb.init_embedding(gen, cfg.vocab_size, cfg.d_model, **kw),
        "ln_in": normnn.init_layernorm(cfg.d_model, **kw),
        "blocks": [init_block(gen, cfg, dev) for _ in range(cfg.num_layers)],
        "final_norm": normnn.init_layernorm(cfg.d_model, **kw),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = init_dense(gen, (cfg.d_model,), (cfg.vocab_size,),
                                  **kw)
    return p


def lm_axes(cfg: ModelConfig) -> dict:
    """Logical axes of :func:`init_lm`'s tree (per-layer dicts without
    the reference's leading ``"layers"`` axis)."""
    axes = {"embed": emb.embedding_axes(), "ln_in": normnn.layernorm_axes(),
            "blocks": [block_axes(cfg) for _ in range(cfg.num_layers)],
            "final_norm": normnn.layernorm_axes()}
    if not cfg.tie_embeddings:
        axes["lm_head"] = dense_axes(("embed",), ("vocab",))
    return axes


def _checkpointed_block(lp, cfg: ModelConfig, x, use_kernel: bool,
                        sp: bool):
    # the recompute in the backward takes the sequence split again
    with seq_parallel(sp):
        return apply_block(lp, cfg, x, use_kernel=use_kernel)[0]


def _run_blocks(params, cfg: ModelConfig, x, states=None,
                use_kernel: bool = True):
    """Apply every block in order.  Returns (x, stacked new states), the
    states None in training under remat."""
    from repro_torch.models.transformer import _remat_blocks, remat_block

    if _remat_blocks(cfg, states):
        for lp in params["blocks"]:
            x = remat_block(cfg, _checkpointed_block, lp, cfg, x, use_kernel,
                            seq_parallel_on())
        return x, None
    new = []
    for layer, lp in enumerate(params["blocks"]):
        st = None if states is None else tuple(s[layer] for s in states)
        x, ns = apply_block(lp, cfg, x, state=st, use_kernel=use_kernel)
        new.append(ns)
    return x, RwkvLayerState(*(torch.stack(s) for s in zip(*new)))


def _logits(params, cfg: ModelConfig, x):
    """The final norm, gathered over the sequence into the head."""
    from repro_torch.models.transformer import reads_split

    x = _layernorm(params["final_norm"], x, eps=cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    x = enter_seq(x, summed=reads_split(head))
    if cfg.tie_embeddings:
        return emb.attend_logits(head, x, compute_dtype=cfg.cdtype)
    return apply_dense(head, into_region(head, x), 1, cfg.cdtype)


def _embed(params, cfg: ModelConfig, tokens):
    x = emb.apply_embedding(params["embed"], tokens, compute_dtype=cfg.cdtype)
    x = own_positions(x, tokens.shape[1] // model_size())
    return _layernorm(params["ln_in"], x, eps=cfg.norm_eps)


def lm_forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
               use_kernel: bool = True) -> torch.Tensor:
    """Training / prefill forward from a zero state: tokens (b, s) ->
    logits (b, s, V).  Sequence-parallel under a mesh whose ``model``
    axis divides the sequence, as the transformer's
    (:func:`repro_torch.models.transformer.lm_forward`)."""
    with seq_parallel(seq_split(tokens.shape[1])):
        x = constrain(_embed(params, cfg, tokens), "batch", "seq_sp",
                      "embed")
        x, _ = _run_blocks(params, cfg, x, use_kernel=use_kernel)
        return constrain(_logits(params, cfg, x), "batch", None, "vocab")


def init_states(cfg: ModelConfig, batch: int, max_len: int, *,
                per_slot: bool = False, device=None) -> RwkvLayerState:
    """Stacked zero decode state.  The recurrent state is O(1) in the
    sequence length and inherently per row: ``max_len`` and ``per_slot``
    are accepted for the API's symmetry with the dense family."""
    del max_len, per_slot
    dev = resolve_device(device)
    h = _num_heads(cfg)
    n = cfg.d_model // h
    L = cfg.num_layers
    return RwkvLayerState(
        wkv=torch.zeros((L, batch, h, n, n), dtype=torch.float32,
                        device=dev),
        tm_x=torch.zeros((L, batch, cfg.d_model), dtype=cfg.cdtype,
                         device=dev),
        cm_x=torch.zeros((L, batch, cfg.d_model), dtype=cfg.cdtype,
                         device=dev))


def lm_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            states: RwkvLayerState):
    """Decode step: tokens (b, t) continue from ``states`` through the
    exact scan.  Returns (logits (b, t, V), new states)."""
    x, new_states = _run_blocks(params, cfg, _embed(params, cfg, tokens),
                                states=states, use_kernel=False)
    return _logits(params, cfg, x), new_states
