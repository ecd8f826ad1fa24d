"""Decoder-only transformer LM, dense family.

Port of the dense path of :mod:`repro.models.transformer`.  Parameters
are a dict whose ``"blocks"`` entry is a list of per-layer dicts (the
reference stacks them on a leading ``("layers",)`` axis and scans); the
forward pass is a Python loop over the layers.

Block (pre-norm)::

    x = x + attention(norm1(x))
    x = x + ffn(norm2(x))

In training (a forward under grad mode with no cache) ``cfg.remat ==
"full"`` wraps each block in ``torch.utils.checkpoint`` (non-reentrant),
as the reference wraps its scan body in ``jax.checkpoint``: only the
block inputs are kept, and each block's forward runs again in the
backward.

Decode state (:func:`init_states`) owns real per-layer storage, allocated
with ``torch.zeros`` — never a broadcast view — because attention writes
each layer's new keys/values into its own slice in place.  Block tables
and cursors are layer-shared: one ``(b, P)`` table and one ``(b,)``
cursor serve every layer.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import (
    KVCache, PagedKVCache, apply_attention, init_attention)
from repro_torch.device import resolve_device
from repro_torch.nn import embedding as emb
from repro_torch.nn import mlp as mlpnn
from repro_torch.nn import norm as normnn
from repro_torch.nn.linear import apply_dense, init_dense


class LayerState(NamedTuple):
    """Decode-time state: the layer-stacked attention cache (k/v carry a
    leading layer axis; tables and cursors are shared by all layers)."""
    kv: Union[KVCache, PagedKVCache, None] = None


def _init_norm(cfg: ModelConfig, device):
    if cfg.norm == "rmsnorm":
        return normnn.init_rmsnorm(cfg.d_model, dtype=cfg.pdtype,
                                   device=device)
    return normnn.init_layernorm(cfg.d_model, dtype=cfg.pdtype, device=device)


def _apply_norm(cfg: ModelConfig, p, x):
    if cfg.norm == "rmsnorm":
        return normnn.apply_rmsnorm(p, x, eps=cfg.norm_eps)
    return normnn.apply_layernorm(p, x, eps=cfg.norm_eps)


def _init_ffn(gen, cfg: ModelConfig, device):
    kw = dict(use_bias=cfg.mlp_bias, dtype=cfg.pdtype, device=device)
    if cfg.mlp == "gated_silu":
        return mlpnn.init_gated_mlp(gen, cfg.d_model, cfg.d_ff, **kw)
    return mlpnn.init_mlp(gen, cfg.d_model, cfg.d_ff, **kw)


def _apply_ffn(cfg: ModelConfig, p, x, cdt):
    if cfg.mlp == "gated_silu":
        return mlpnn.apply_gated_mlp(p, x, activation="silu",
                                     compute_dtype=cdt)
    act = "gelu" if cfg.mlp == "mlp_gelu" else "relu"
    return mlpnn.apply_mlp(p, x, activation=act, compute_dtype=cdt)


def init_block(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    from repro_torch.core.mechanism import (get_mechanism,
                                            resolve_mechanism_name)

    get_mechanism(resolve_mechanism_name(cfg.attention))  # fail fast
    return {
        "ln1": _init_norm(cfg, device),
        "attn": init_attention(gen, cfg.attention, cfg.d_model,
                               dtype=cfg.pdtype, device=device),
        "ln2": _init_norm(cfg, device),
        "ffn": _init_ffn(gen, cfg, device),
    }


def apply_block(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
                positions=None, cache=None):
    """Returns (x, new_cache) for one layer (``cache`` is that layer's
    KVCache / PagedKVCache view, or None)."""
    cdt = cfg.cdtype
    h = _apply_norm(cfg, params["ln1"], x)
    a, new_cache = apply_attention(params["attn"], cfg.attention, h,
                                   positions=positions, cache=cache,
                                   compute_dtype=cdt)
    x = x + a
    h2 = _apply_norm(cfg, params["ln2"], x)
    x = x + _apply_ffn(cfg, params["ffn"], h2, cdt)
    return x, new_cache


def init_lm(gen: torch.Generator, cfg: ModelConfig, *, device=None) -> dict:
    """Random parameters from ``gen`` (a CPU generator), on ``device``
    (default ``cuda``; raises when no card is present)."""
    dev = resolve_device(device)
    p = {
        "blocks": [init_block(gen, cfg, dev) for _ in range(cfg.num_layers)],
        "embed": emb.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                    dtype=cfg.pdtype, device=dev),
        "final_norm": _init_norm(cfg, dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = init_dense(gen, (cfg.d_model,), (cfg.vocab_size,),
                                  dtype=cfg.pdtype, device=dev)
    return p


def _layer_cache(kv, layer: int):
    if kv is None:
        return None
    return kv._replace(k=kv.k[layer], v=kv.v[layer])


def _remat_blocks(cfg: ModelConfig, kv) -> bool:
    """Checkpoint each block?  Only in training: grad mode, no cache."""
    if kv is not None or not torch.is_grad_enabled() or cfg.remat == "none":
        return False
    if cfg.remat == "full":
        return True
    raise NotImplementedError(
        f"remat={cfg.remat!r} is not ported to PyTorch yet (ROADMAP queue "
        f"1 item 6: remat \"dots\" / \"offload\")")


def _checkpointed_block(lp, cfg: ModelConfig, x, positions):
    return apply_block(lp, cfg, x, positions=positions)[0]


def _run_blocks(params, cfg: ModelConfig, x, positions, kv=None):
    """Apply every block in order; ``kv`` is the layer-stacked cache whose
    per-layer slices the blocks update in place.  Returns (x, kv')."""
    if _remat_blocks(cfg, kv):
        for lp in params["blocks"]:
            x = torch.utils.checkpoint.checkpoint(
                _checkpointed_block, lp, cfg, x, positions,
                use_reentrant=False)
        return x, None
    new_length = None
    for layer, lp in enumerate(params["blocks"]):
        x, c = apply_block(lp, cfg, x, positions=positions,
                           cache=_layer_cache(kv, layer))
        if c is not None:
            new_length = c.length
    if kv is None:
        return x, None
    return x, kv._replace(length=new_length)


def _logits(params, cfg: ModelConfig, x):
    x = _apply_norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        return emb.attend_logits(params["embed"], x, compute_dtype=cfg.cdtype)
    return apply_dense(params["lm_head"], x, 1, cfg.cdtype)


def lm_forward(params: dict, cfg: ModelConfig,
               tokens: torch.Tensor) -> torch.Tensor:
    """Prefill forward without a cache: tokens (b, s) -> logits (b, s, V)."""
    x = emb.apply_embedding(params["embed"], tokens, compute_dtype=cfg.cdtype)
    x, _ = _run_blocks(params, cfg, x, None)
    return _logits(params, cfg, x)


def fused_gather_applies(cfg: ModelConfig, kv, n_q: int) -> bool:
    """Would :func:`lm_step` hoist the all-layer page gather for this paged
    state?  True exactly when the per-layer planner would pick the gather
    ``paged`` backend with nothing forced; where it picks the paged
    decode kernel (CUDA, single-query) the kernel runs per layer."""
    from repro_torch.core.mechanism import AttnShapes, plan_attention

    if not isinstance(kv, PagedKVCache):
        return False
    a = cfg.attention
    if a.backend is not None or a.use_kernel:
        return False
    ps = kv.k.shape[2]
    shapes = AttnShapes(
        batch=kv.block_tables.shape[0], n_q=n_q,
        n_k=kv.block_tables.shape[1] * ps, num_heads=a.num_heads,
        num_kv_heads=kv.k.shape[3], head_dim=a.head_dim, dtype=cfg.cdtype,
        has_explicit_mask=False, is_cross=False, has_cache=True,
        scalar_cursor=False, platform=kv.k.device.type, paged=True)
    try:
        plan = plan_attention(a, shapes)
    except ValueError:
        return False
    return plan.backend == "paged"


def _gather_paged_view(kv: PagedKVCache) -> KVCache:
    """ONE whole-model page gather: stacked pools (L, pages, ps, hk, d) ->
    contiguous logical view (L, b, P·ps, hk, d) (a copy)."""
    tables = kv.block_tables.long()                   # (b, P), layer-shared
    ps = kv.k.shape[2]
    page_idx = tables.repeat_interleave(ps, dim=1)    # (b, N): tables[b, j//ps]
    off_idx = torch.arange(ps, device=tables.device).repeat(
        tables.shape[1])[None]                        # (1, N): j % ps
    return KVCache(kv.k[:, page_idx, off_idx], kv.v[:, page_idx, off_idx],
                   kv.length)


def _scatter_paged_rows(kv: PagedKVCache, view: KVCache,
                        n_q: int) -> PagedKVCache:
    """Write the ``n_q`` rows each layer appended to the logical view back
    into the page pool, in place (inactive rows land on trash page 0)."""
    tables = kv.block_tables.long()
    ps = kv.k.shape[2]
    n = view.k.shape[2]
    dev = tables.device
    rows = torch.arange(tables.shape[0], device=dev)[:, None]       # (b, 1)
    pos = (kv.length.long()[:, None]
           + torch.arange(n_q, device=dev)[None]).clamp(max=n - 1)  # (b, t)
    pages = tables[rows, (pos // ps).clamp(max=tables.shape[1] - 1)]
    offs = pos % ps
    kv.k[:, pages, offs] = view.k[:, rows, pos]
    kv.v[:, pages, offs] = view.v[:, rows, pos]
    return kv._replace(length=view.length)


def init_states(cfg: ModelConfig, batch: int, max_len: int, *,
                per_slot: bool = False, paged: bool = False,
                page_size: int = 16, num_pages: Optional[int] = None,
                device=None) -> LayerState:
    """Layer-stacked decode state for the LM, in the compute dtype.

    ``per_slot``: per-row cursors (ragged continuous batching).
    ``paged``: KV rows in a shared page pool behind block tables (cursors
    are then always per-slot).
    """
    dev = resolve_device(device)
    a = cfg.attention
    row = (a.num_kv_heads, a.head_dim)
    if paged:
        pages_per_slot = -(-max_len // page_size)
        if num_pages is None:
            num_pages = batch * pages_per_slot + 1      # +1: trash page 0
        shape = (cfg.num_layers, num_pages, page_size) + row
        kv = PagedKVCache(
            torch.zeros(shape, dtype=cfg.cdtype, device=dev),
            torch.zeros(shape, dtype=cfg.cdtype, device=dev),
            torch.zeros((batch, pages_per_slot), dtype=torch.int32,
                        device=dev),
            torch.zeros((batch,), dtype=torch.int32, device=dev))
    else:
        shape = (cfg.num_layers, batch, max_len) + row
        kv = KVCache(
            torch.zeros(shape, dtype=cfg.cdtype, device=dev),
            torch.zeros(shape, dtype=cfg.cdtype, device=dev),
            torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                        device=dev))
    return LayerState(kv=kv)


def lm_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            states: LayerState):
    """Decode step: tokens (b, t) appended at the cursors.

    Returns (logits (b, t, V), new_states); the new state shares the KV
    storage of ``states`` (written in place) with the cursors advanced.
    """
    cdt = cfg.cdtype
    x = emb.apply_embedding(params["embed"], tokens, compute_dtype=cdt)
    t = x.shape[1]
    kv = states.kv
    if fused_gather_applies(cfg, kv, t):
        # whole-model gather: one gather of the paged pools into a
        # contiguous logical view, every layer on its slice through the
        # masked ``fused`` backend, then one scatter of the appended rows
        # back into the pool (the prefill-chunk path, and the CPU's
        # decode)
        run_cfg = dataclasses.replace(
            cfg, attention=dataclasses.replace(cfg.attention,
                                               backend="fused"))
        x, new_view = _run_blocks(params, run_cfg, x, None,
                                  _gather_paged_view(kv))
        new_kv = _scatter_paged_rows(kv, new_view, t)
    else:
        x, new_kv = _run_blocks(params, cfg, x, None, kv)
    return _logits(params, cfg, x), LayerState(kv=new_kv)
