"""Encoder-decoder transformer (the seamless-m4t family).

Port of :mod:`repro.models.encdec`.  The frontend is a stub, as in the
reference: the encoder consumes precomputed frame embeddings (b,
n_frames, frontend embed_dim), projected by ``frontend_proj``.  The
parameters keep each stack as a list of per-layer dicts (``"encoder"``,
``"decoder"``), as the port keeps ``"blocks"``; the reference stacks
them on a leading layer axis and scans.

Encoder layer (pre-norm): non-causal self-attention, then a ReLU MLP
with bias.  Decoder layer: causal self-attention (cached when decoding),
cross-attention over the encoder memory (no RoPE, planned with
``is_cross``: ``chunked`` or ``fused``, never a kernel), then the MLP.
Each stack ends in its norm.  seamless-m4t has ``use_rope=False`` and no
learned positions, so neither stack sees a position, as in the
reference.

In training (grad mode) ``cfg.remat == "full"`` checkpoints each layer
(``models.transformer.remat_block``); every other policy, ``"dots"``
included, runs without checkpointing, as the reference's
``jax.checkpoint(body) if cfg.remat == "full" else body``.

The decode cache (:func:`init_states`) is one contiguous ``KVCache`` per
decoder layer, stacked on a leading layer axis, with one scalar cursor
per layer (``length`` of shape (L,)); :func:`decode_step` writes each
layer's new rows into its slice in place and advances every cursor.

Under the sharded steps the self- and cross-attentions, the MLPs, the
embedding and the head compute tensor-parallel over ``model`` through
the same layers as the decoder-only families; on a sequence-parallel
stream an attention computed whole computes the rank's query rows, over
the whole sequence's keys (self) or the whole memory (cross).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import (AttentionConfig, KVCache,
                                        apply_attention, attention_axes,
                                        init_attention, query_split)
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (
    constrain, enter_seq, into_region, model_size, own_positions,
    seq_parallel, seq_parallel_on, seq_split)
from repro_torch.models import transformer as tfm
from repro_torch.nn import embedding as emb
from repro_torch.nn import mlp as mlpnn
from repro_torch.nn.linear import apply_dense, dense_axes, init_dense


class DecLayerState(NamedTuple):
    kv: KVCache        # k, v (L, b, max_len, h_kv, d); length (L,) int32


def _enc_attn_cfg(cfg: ModelConfig) -> AttentionConfig:
    return dataclasses.replace(cfg.attention, causal=False)


def _cross_attn_cfg(cfg: ModelConfig) -> AttentionConfig:
    return dataclasses.replace(cfg.attention, causal=False, use_rope=False)


def _init_ffn(gen, cfg: ModelConfig, device) -> dict:
    return mlpnn.init_mlp(gen, cfg.d_model, cfg.d_ff, use_bias=True,
                          dtype=cfg.pdtype, device=device)


def _apply_ffn(p, x, cdt):
    return mlpnn.apply_mlp(p, x, activation="relu", compute_dtype=cdt)


def init_enc_block(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    kw = dict(dtype=cfg.pdtype, device=device)
    return {
        "ln1": tfm._init_norm(cfg, device),
        "attn": init_attention(gen, _enc_attn_cfg(cfg), cfg.d_model, **kw),
        "ln2": tfm._init_norm(cfg, device),
        "ffn": _init_ffn(gen, cfg, device),
    }


def init_dec_block(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    kw = dict(dtype=cfg.pdtype, device=device)
    return {
        "ln1": tfm._init_norm(cfg, device),
        "self_attn": init_attention(gen, cfg.attention, cfg.d_model, **kw),
        "ln_cross": tfm._init_norm(cfg, device),
        "cross_attn": init_attention(gen, _cross_attn_cfg(cfg), cfg.d_model,
                                     **kw),
        "ln2": tfm._init_norm(cfg, device),
        "ffn": _init_ffn(gen, cfg, device),
    }


def init_model(gen: torch.Generator, cfg: ModelConfig, *,
               device=None) -> dict:
    """Random parameters from ``gen`` on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    ed = cfg.encdec
    return {
        "frontend_proj": init_dense(gen, (cfg.frontend.embed_dim,),
                                    (cfg.d_model,), use_bias=True,
                                    dtype=cfg.pdtype, device=dev),
        "embed": emb.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                    dtype=cfg.pdtype, device=dev),
        "encoder": [init_enc_block(gen, cfg, dev)
                    for _ in range(ed.encoder_layers)],
        "enc_norm": tfm._init_norm(cfg, dev),
        "decoder": [init_dec_block(gen, cfg, dev)
                    for _ in range(ed.decoder_layers)],
        "dec_norm": tfm._init_norm(cfg, dev),
        "lm_head": init_dense(gen, (cfg.d_model,), (cfg.vocab_size,),
                              dtype=cfg.pdtype, device=dev),
    }


def model_axes(cfg: ModelConfig) -> dict:
    """Logical axes of :func:`init_model`'s tree (per-layer dicts without
    the reference's leading ``"layers"`` axis)."""
    norm = tfm._norm_axes(cfg)
    ffn = mlpnn.mlp_axes(use_bias=True)
    ed = cfg.encdec
    enc = {"ln1": norm, "attn": attention_axes(_enc_attn_cfg(cfg)),
           "ln2": norm, "ffn": ffn}
    dec = {"ln1": norm, "self_attn": attention_axes(cfg.attention),
           "ln_cross": norm,
           "cross_attn": attention_axes(_cross_attn_cfg(cfg)),
           "ln2": norm, "ffn": ffn}
    return {
        "frontend_proj": dense_axes((None,), ("embed",), use_bias=True),
        "embed": emb.embedding_axes(),
        "encoder": [enc] * ed.encoder_layers,
        "enc_norm": norm,
        "decoder": [dec] * ed.decoder_layers,
        "dec_norm": norm,
        "lm_head": dense_axes(("embed",), ("vocab",)),
    }


def _checkpointed(cfg: ModelConfig) -> bool:
    """Checkpoint each layer?  Only in training, and only under remat
    "full" (the reference's two stacks know no other policy)."""
    if cfg.remat not in tfm.REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {cfg.remat!r}; known: "
                         f"{tfm.REMAT_POLICIES}")
    return cfg.remat == "full" and torch.is_grad_enabled()


def _positions(b: int, t: int, offset, device) -> torch.Tensor:
    return (torch.arange(t, device=device)[None] + offset).expand(b, t)


def _sublayer(lp, h, fn):
    """``fn`` on the norm output ``h`` (at the residual's positions)
    gathered over the sequence, its result at the residual's positions
    (both the identity outside a sequence-parallel stream)."""
    return own_positions(fn(enter_seq(h, summed=tfm.reads_split(lp))),
                         h.shape[1])


def _attend(lp, acfg: AttentionConfig, h, cdt, **kw):
    """The attention ``lp`` on the norm output ``h`` (at the residual's
    positions) -> (its output at those positions, cache').  One computed
    whole on a sequence-parallel stream takes its queries from ``h``
    itself (:func:`~repro_torch.core.attention.query_split`); a split one
    reads ``h`` gathered over the sequence and leaves its region at the
    rank's positions."""
    x = h if query_split(lp) else enter_seq(h, summed=tfm.reads_split(lp))
    return apply_attention(lp, acfg, x, compute_dtype=cdt, **kw)


def _enc_block(lp, cfg: ModelConfig, h, positions, sp: bool = False):
    cdt = cfg.cdtype
    with seq_parallel(sp):
        # non-causal: a query split's offset moves no mask
        h = h + _attend(lp["attn"], _enc_attn_cfg(cfg),
                        tfm._apply_norm(cfg, lp["ln1"], h), cdt,
                        positions=positions)[0]
        h = h + _sublayer(lp["ffn"], tfm._apply_norm(cfg, lp["ln2"], h),
                          lambda g: _apply_ffn(lp["ffn"], g, cdt))
    return constrain(h, "batch", "seq_sp", "embed")


def encode(params: dict, cfg: ModelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """frames (b, n_src, frontend embed_dim) -> memory (b, n_src, d).
    Sequence-parallel over the frames where ``model`` divides them; the
    memory comes back whole, for every decoder layer's cross-attention."""
    cdt = cfg.cdtype
    x = apply_dense(params["frontend_proj"], frames.to(cdt), 1, cdt)
    b, s, _ = x.shape
    positions = _positions(b, s, 0, x.device)
    remat = _checkpointed(cfg)
    with seq_parallel(seq_split(s)):
        sp = seq_parallel_on()
        x = own_positions(x, s // model_size())
        for lp in params["encoder"]:
            x = (tfm.remat_block(cfg, _enc_block, lp, cfg, x, positions, sp)
                 if remat else _enc_block(lp, cfg, x, positions, sp))
        # gathered whole before the decoder's cross-attentions read it;
        # its gradient arrives whole and alike on every rank (a split or a
        # query-split cross-attention sums its own share over ``model``),
        # so the backward keeps the rank's positions
        return enter_seq(tfm._apply_norm(cfg, params["enc_norm"], x),
                         summed=False)


def _dec_block(lp, cfg: ModelConfig, h, memory, positions, cache=None,
               sp: bool = False):
    cdt = cfg.cdtype
    with seq_parallel(sp):
        a, new_kv = _attend(lp["self_attn"], cfg.attention,
                            tfm._apply_norm(cfg, lp["ln1"], h), cdt,
                            positions=positions, cache=cache)
        h = h + a
        # a query split's rows attend the whole memory: its gradient into
        # the memory is the rank's rows' share, summed in apply_attention
        h = h + _attend(lp["cross_attn"], _cross_attn_cfg(cfg),
                        tfm._apply_norm(cfg, lp["ln_cross"], h), cdt,
                        x_kv=memory)[0]
        h = h + _sublayer(lp["ffn"], tfm._apply_norm(cfg, lp["ln2"], h),
                          lambda g: _apply_ffn(lp["ffn"], g, cdt))
    return constrain(h, "batch", "seq_sp", "embed"), new_kv


def _head(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = tfm._apply_norm(cfg, params["dec_norm"], x)
    x = enter_seq(x, summed=tfm.reads_split(params["lm_head"]))
    return apply_dense(params["lm_head"], into_region(params["lm_head"], x),
                       1, cfg.cdtype)


def decode_train(params: dict, cfg: ModelConfig, memory: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder: tokens (b, t) -> logits (b, t, V),
    sequence-parallel over the tokens where ``model`` divides them."""
    b, t = tokens.shape
    positions = _positions(b, t, 0, tokens.device)
    remat = _checkpointed(cfg)
    with seq_parallel(seq_split(t)):
        sp = seq_parallel_on()
        x = emb.apply_embedding(params["embed"], tokens,
                                compute_dtype=cfg.cdtype)
        x = own_positions(x, t // model_size())
        for lp in params["decoder"]:
            x, _ = (tfm.remat_block(cfg, _dec_block, lp, cfg, x, memory,
                                    positions, None, sp) if remat
                    else _dec_block(lp, cfg, x, memory, positions, sp=sp))
        return constrain(_head(params, cfg, x), "batch", None, "vocab")


def forward_train(params: dict, cfg: ModelConfig, frames: torch.Tensor,
                  tokens: torch.Tensor) -> torch.Tensor:
    """The seq2seq training forward: (frames, target tokens) -> logits."""
    return decode_train(params, cfg, encode(params, cfg, frames), tokens)


def init_states(cfg: ModelConfig, batch: int, max_len: int, *,
                per_slot: bool = False, device=None) -> DecLayerState:
    """Zero decode cache in the compute dtype: k, v (L, batch, max_len,
    h_kv, d) of real per-layer storage, one scalar cursor per layer."""
    if per_slot:
        raise ValueError("the encoder-decoder's decode cache has one scalar "
                         "cursor per layer (no per-slot cursors)")
    dev = resolve_device(device)
    a = cfg.attention
    L = cfg.encdec.decoder_layers
    shape = (L, batch, max_len, a.num_kv_heads, a.head_dim)
    return DecLayerState(kv=KVCache(
        torch.zeros(shape, dtype=cfg.cdtype, device=dev),
        torch.zeros(shape, dtype=cfg.cdtype, device=dev),
        torch.zeros((L,), dtype=torch.int32, device=dev)))


def decode_step(params: dict, cfg: ModelConfig, memory: torch.Tensor,
                tokens: torch.Tensor, states: DecLayerState):
    """Incremental decode: tokens (b, t) appended at the cache cursor.
    Returns (logits (b, t, V), states'); the new state shares the cache
    storage of ``states`` (written in place), its cursors advanced."""
    x = emb.apply_embedding(params["embed"], tokens, compute_dtype=cfg.cdtype)
    b, t, _ = x.shape
    kv = states.kv
    positions = _positions(b, t, kv.length[0].long(), x.device)
    lengths = []
    for layer, lp in enumerate(params["decoder"]):
        cache = KVCache(kv.k[layer], kv.v[layer], kv.length[layer])
        x, new = _dec_block(lp, cfg, x, memory, positions, cache)
        lengths.append(new.length)
    new_kv = kv._replace(length=torch.stack(lengths))
    return _head(params, cfg, x), DecLayerState(kv=new_kv)
