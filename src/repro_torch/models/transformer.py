"""Decoder-only transformer LM: the dense, MoE, hybrid and vlm families.

Port of :mod:`repro.models.transformer`.  Parameters are a dict whose
``"blocks"`` entry is a list of per-layer dicts (the reference stacks
them on a leading ``("layers",)`` axis and scans); the forward pass is a
Python loop over the layers.

Block (pre-norm)::

    a = attention(norm1(x))             # hybrid: attention ∥ mamba,
    x = x + a                           #   a = 0.5·(s0·attn + s1·mamba)
    x = x + ffn_or_moe(norm2(x))

The MoE family's layers return the (load-balance, router-z) auxiliary
losses, summed over layers; :func:`lm_forward` returns them only when
asked (``return_aux``), for the training loss.

In training (a forward under grad mode with no cache) ``cfg.remat ==
"full"`` wraps each block in ``torch.utils.checkpoint`` (non-reentrant),
as the reference wraps its scan body in ``jax.checkpoint``: only the
block inputs are kept, and each block's forward runs again in the
backward.  ``"dots"`` is the same checkpoint with a selective policy
that keeps the outputs of the matmuls without batch dimensions
(``aten.mm`` / ``aten.addmm``: the projections and the MLP), as
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` does, and
recomputes the rest.  ``"offload"`` checkpoints nothing: the reference's
scan has branches for ``"full"`` and ``"dots"`` only, so it runs
``"offload"`` as ``"none"``.

Decode state (:func:`init_states`) owns real per-layer storage, allocated
with ``torch.zeros`` — never a broadcast view — because attention writes
each layer's new keys/values into its own slice in place.  Block tables
and cursors are layer-shared: one ``(b, P)`` table and one ``(b,)``
cursor serve every layer.  The hybrid family's Mamba carries (``ssm``,
``conv``) are real storage too; :func:`lm_step` returns them as new
tensors, which a caller that keeps its state's storage (the serving
engine) copies back.

Under the sharded steps (:mod:`repro_torch.launch.shardings`) a layer
handed as a :class:`~repro_torch.distributed.sharding.ModelShards`
computes tensor-parallel over ``model`` (attention heads, MLP hidden,
experts, the hybrid family's Mamba inner channels, vocabulary rows: the
logits are then this rank's vocabulary columns).  On a sequence-parallel
stream an attention computed whole computes only the rank's query rows
(``core.attention.query_split``).  Outside a mesh every layer is whole
and the logits cover the vocabulary.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Union

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import (
    KVCache, PagedKVCache, apply_attention, attention_axes, init_attention,
    query_split)
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (
    at_positions, constrain, enter_seq, into_region, is_split, model_size,
    own_positions, seq_parallel, seq_parallel_on, seq_split)
from repro_torch.nn import embedding as emb
from repro_torch.nn import mlp as mlpnn
from repro_torch.nn import moe as moenn
from repro_torch.nn import norm as normnn
from repro_torch.nn import ssm as ssmnn
from repro_torch.nn.linear import apply_dense, dense_axes, init_dense


class LayerState(NamedTuple):
    """Decode-time state: the layer-stacked attention cache (k/v carry a
    leading layer axis; tables and cursors are shared by all layers) and,
    for the hybrid family, the Mamba carries."""
    kv: Union[KVCache, PagedKVCache, None] = None
    ssm: Optional[torch.Tensor] = None    # (L, b, inner, n) float32
    conv: Optional[torch.Tensor] = None   # (L, b, conv_dim - 1, inner)


def _init_norm(cfg: ModelConfig, device):
    if cfg.norm == "rmsnorm":
        return normnn.init_rmsnorm(cfg.d_model, dtype=cfg.pdtype,
                                   device=device)
    return normnn.init_layernorm(cfg.d_model, dtype=cfg.pdtype, device=device)


def _norm_axes(cfg: ModelConfig) -> dict:
    return normnn.layernorm_axes(use_bias=cfg.norm != "rmsnorm")


def _apply_norm(cfg: ModelConfig, p, x):
    p = {k: at_positions(v) for k, v in p.items()}
    if cfg.norm == "rmsnorm":
        return normnn.apply_rmsnorm(p, x, eps=cfg.norm_eps)
    return normnn.apply_layernorm(p, x, eps=cfg.norm_eps)


def _init_ffn(gen, cfg: ModelConfig, device):
    kw = dict(use_bias=cfg.mlp_bias, dtype=cfg.pdtype, device=device)
    if cfg.mlp == "gated_silu":
        return mlpnn.init_gated_mlp(gen, cfg.d_model, cfg.d_ff, **kw)
    return mlpnn.init_mlp(gen, cfg.d_model, cfg.d_ff, **kw)


def _ffn_axes(cfg: ModelConfig) -> dict:
    if cfg.mlp == "gated_silu":
        return mlpnn.gated_mlp_axes(use_bias=cfg.mlp_bias)
    return mlpnn.mlp_axes(use_bias=cfg.mlp_bias)


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
    kw = dict(dtype=cfg.pdtype, device=device)
    p = {
        "ln1": _init_norm(cfg, device),
        "attn": init_attention(gen, cfg.attention, cfg.d_model, **kw),
        "ln2": _init_norm(cfg, device),
    }
    if cfg.family == "hybrid":
        if cfg.ssm is None or cfg.ssm.kind != "mamba":
            raise ValueError(f"the hybrid family needs a mamba SSMConfig, "
                             f"got {cfg.ssm}")
        p["mamba"] = ssmnn.init_mamba(
            gen, cfg.d_model, _mamba_inner(cfg), state_dim=cfg.ssm.state_dim,
            conv_dim=cfg.ssm.conv_dim, dt_rank=cfg.ssm.dt_rank, **kw)
        # learned per-branch output scales (hymba averages the branches)
        p["branch_scale"] = torch.ones(2, **kw)
    if cfg.moe is not None:
        p["moe"] = moenn.init_moe(
            gen, cfg.d_model, cfg.moe.expert_hidden_dim,
            cfg.moe.effective_experts,
            shared_hidden_dim=cfg.moe.shared_hidden_dim,
            shared_gate=cfg.moe.shared_gate, **kw)
    else:
        p["ffn"] = _init_ffn(gen, cfg, device)
    return p


def block_axes(cfg: ModelConfig) -> dict:
    """Logical axes of :func:`init_block`'s tree."""
    axes = {"ln1": _norm_axes(cfg), "attn": attention_axes(cfg.attention),
            "ln2": _norm_axes(cfg)}
    if cfg.family == "hybrid":
        axes["mamba"] = ssmnn.mamba_axes()
        axes["branch_scale"] = (None,)
    if cfg.moe is not None:
        axes["moe"] = moenn.moe_axes(
            shared_hidden_dim=cfg.moe.shared_hidden_dim,
            shared_gate=cfg.moe.shared_gate)
    else:
        axes["ffn"] = _ffn_axes(cfg)
    return axes


def _mamba_inner(cfg: ModelConfig) -> int:
    return cfg.ssm.inner_dim or 2 * cfg.d_model


def apply_block(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
                positions=None, cache=None, ssm=None, conv=None):
    """One layer.  ``cache`` is that layer's KVCache / PagedKVCache view
    (or None); ``ssm`` / ``conv`` its Mamba carries (hybrid; zeros when
    None).  Returns (x, new_cache, carries, aux): ``carries`` the new
    (ssm, conv) of a hybrid layer, else None; ``aux`` the MoE's
    (load-balance, router-z) losses as a (2,) float32 tensor, else None.
    """
    cdt = cfg.cdtype
    n = x.shape[1]          # the residual's positions: s/M under SP
    h = _apply_norm(cfg, params["ln1"], x)
    h = constrain(h, "batch", "seq_sp", "embed")
    readers = [params["attn"]] + ([params["mamba"]]
                                  if cfg.family == "hybrid" else [])
    hs = enter_seq(h, summed=reads_split(*readers))
    # a split attention reads the whole sequence and leaves its region at
    # the rank's positions; one computed whole takes its queries from
    # them, its keys and values from the whole sequence: either way its
    # output lies at the residual's positions
    rows = query_split(params["attn"])
    a, new_cache = apply_attention(
        params["attn"], cfg.attention, h if rows else hs,
        seq_kv=hs if rows else None, positions=positions, cache=cache,
        compute_dtype=cdt)
    carries = None
    if cfg.family == "hybrid":
        m, carries = ssmnn.apply_mamba(
            params["mamba"], hs, state_dim=cfg.ssm.state_dim, ssm_state=ssm,
            conv_state=conv, compute_dtype=cdt)
        # two branches in one block: each split branch leaves its region
        # (summed over the ranks) before its scale, so branch_scale's
        # gradient is whole and the same on every rank
        s = at_positions(params["branch_scale"]).to(cdt)
        a = 0.5 * (s[0] * a + s[1] * own_positions(m, n))
    x = x + a
    x = constrain(x, "batch", "seq_sp", "embed")
    h2 = _apply_norm(cfg, params["ln2"], x)
    aux = None
    if cfg.moe is not None:
        # the MoE's global capacity and slots need the whole sequence,
        # and its routing is computed alike on every rank
        f, moe_aux = moenn.apply_moe(
            params["moe"], enter_seq(h2, summed=False), top_k=cfg.moe.top_k,
            capacity_factor=cfg.moe.capacity_factor,
            normalize_topk=cfg.moe.normalize_topk, compute_dtype=cdt)
        aux = torch.stack([moe_aux.load_balance_loss, moe_aux.router_z_loss])
    else:
        f = _apply_ffn(cfg, params["ffn"],
                       enter_seq(h2, summed=reads_split(params["ffn"])), cdt)
    x = constrain(x + own_positions(f, n), "batch", "seq_sp", "embed")
    return x, new_cache, carries, aux


def reads_split(*layers) -> bool:
    """Do these layers, which read one gathered norm output, each take a
    partial sum of its gradient on every rank (the all-gather's backward
    then a reduce-scatter,
    :func:`~repro_torch.distributed.sharding.enter_seq`)?  A split layer
    does, and so does an attention computing the rank's query rows
    (:func:`~repro_torch.core.attention.query_split`: its K / V gradient
    is its queries' share); not another layer computed whole, an
    attention that projects K / V whole, or an MoE (its router).  (The
    RWKV-6 blocks gather for their mixers with ``summed`` False: the
    ddlerp mix and the receptance gate compute alike on every rank.)"""
    return all(("wq" in p and query_split(p))
               or (is_split(p) and "wk" not in p.whole and "router" not in p)
               for p in layers)


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
    if cfg.frontend is not None:
        # the vlm family's frontend stub: patch embeddings -> d_model
        p["frontend_proj"] = init_dense(
            gen, (cfg.frontend.embed_dim,), (cfg.d_model,), use_bias=True,
            dtype=cfg.pdtype, device=dev)
    return p


def lm_axes(cfg: ModelConfig) -> dict:
    """Logical axes of :func:`init_lm`'s tree: the reference's, with each
    per-layer dict's leading ``"layers"`` axis dropped."""
    axes = {"blocks": [block_axes(cfg) for _ in range(cfg.num_layers)],
            "embed": emb.embedding_axes(), "final_norm": _norm_axes(cfg)}
    if not cfg.tie_embeddings:
        axes["lm_head"] = dense_axes(("embed",), ("vocab",))
    if cfg.frontend is not None:
        axes["frontend_proj"] = dense_axes((None,), ("embed",),
                                           use_bias=True)
    return axes


def _layer_cache(kv, layer: int):
    if kv is None:
        return None
    return kv._replace(k=kv.k[layer], v=kv.v[layer])


REMAT_POLICIES = ("none", "full", "dots", "offload")


def _remat_blocks(cfg: ModelConfig, kv) -> bool:
    """Checkpoint each block?  Only in training (grad mode, no cache), and
    only under remat "full" or "dots"."""
    if cfg.remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {cfg.remat!r}; known: "
                         f"{REMAT_POLICIES}")
    if kv is not None or not torch.is_grad_enabled():
        return False
    return cfg.remat in ("full", "dots")


#: the ops whose outputs remat "dots" keeps: matmuls without batch dims
_DOTS_SAVEABLE = frozenset({torch.ops.aten.mm.default,
                            torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVEABLE
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_block(cfg: ModelConfig, fn, *args):
    """``fn(*args)`` under the block checkpoint of ``cfg.remat`` ("full"
    or "dots"; see :func:`_remat_blocks`)."""
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            torch.utils.checkpoint.create_selective_checkpoint_contexts,
            _dots_policy)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             **kw)


def _checkpointed_block(lp, cfg: ModelConfig, x, positions, sp: bool):
    # the recompute in the backward runs outside lm_forward: it takes the
    # sequence split again, so it runs the same collectives
    with seq_parallel(sp):
        x, _, _, aux = apply_block(lp, cfg, x, positions=positions)
    return x, aux


def _add_aux(total, aux):
    if aux is None:
        return total
    return aux if total is None else total + aux


def _run_blocks(params, cfg: ModelConfig, x, positions,
                states: Optional[LayerState] = None):
    """Apply every block in order.  ``states.kv`` is the layer-stacked
    cache whose per-layer slices the blocks update in place; the Mamba
    carries are read per layer and returned stacked, as new tensors.
    Returns (x, states' or None, the MoE aux losses summed over layers or
    None)."""
    kv = states.kv if states is not None else None
    aux_total = None
    if _remat_blocks(cfg, kv):
        for lp in params["blocks"]:
            x, aux = remat_block(cfg, _checkpointed_block, lp, cfg, x,
                                 positions, seq_parallel_on())
            aux_total = _add_aux(aux_total, aux)
        return x, None, aux_total
    new_length = None
    ssm, conv = [], []
    for layer, lp in enumerate(params["blocks"]):
        carry = (None, None)
        if states is not None and states.ssm is not None:
            carry = (states.ssm[layer], states.conv[layer])
        x, c, carries, aux = apply_block(
            lp, cfg, x, positions=positions, cache=_layer_cache(kv, layer),
            ssm=carry[0], conv=carry[1])
        aux_total = _add_aux(aux_total, aux)
        if c is not None:
            new_length = c.length
        if carries is not None:
            ssm.append(carries[0])
            conv.append(carries[1])
    if states is None:
        return x, None, aux_total
    new = LayerState(kv=kv._replace(length=new_length))
    if ssm:
        new = new._replace(ssm=torch.stack(ssm), conv=torch.stack(conv))
    return x, new, aux_total


def _logits(params, cfg: ModelConfig, x):
    """The final norm, gathered over the sequence into the head: logits
    (b, s, V) for every position (this rank's vocabulary columns where
    the head is split)."""
    x = _apply_norm(cfg, params["final_norm"], x)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    x = enter_seq(x, summed=reads_split(head))
    if cfg.tie_embeddings:
        return emb.attend_logits(head, x, compute_dtype=cfg.cdtype)
    return apply_dense(head, into_region(head, x), 1, cfg.cdtype)


def lm_forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
               extra_embeds: Optional[torch.Tensor] = None,
               return_aux: bool = False):
    """Prefill forward without a cache: tokens (b, s) -> logits (b, s, V);
    with ``return_aux``, (logits, aux (2,)): the MoE's load-balance and
    router-z losses summed over layers (zeros for the other families).

    ``extra_embeds`` (b, n_extra, frontend embed_dim): the vlm family's
    patch embeddings, projected by ``frontend_proj`` and prepended to the
    token embeddings; positions then run over the whole n_extra + s
    sequence and the logits cover it.

    Under a mesh whose ``model`` axis divides the sequence
    (:func:`~repro_torch.distributed.sharding.seq_split`) the residual
    stream between the regions is sequence-parallel: each ``model`` rank
    holds its (b, s/M, d) positions, the norms run on them, and the
    logits are gathered whole over the sequence."""
    cdt = cfg.cdtype
    n = tokens.shape[1] + (0 if extra_embeds is None
                           else extra_embeds.shape[1])
    sp = seq_split(n)
    # the vocab-parallel embedding leaves its region at the rank's
    # positions; behind image positions it leaves whole
    with seq_parallel(sp and extra_embeds is None):
        x = emb.apply_embedding(params["embed"], tokens, compute_dtype=cdt)
    if extra_embeds is not None:
        fe = apply_dense(params["frontend_proj"], extra_embeds.to(cdt), 1,
                         cdt)
        x = torch.cat([fe, x], dim=1)
    with seq_parallel(sp):
        x = own_positions(x, n // model_size())
        x = constrain(x, "batch", "seq_sp", "embed")
        x, _, aux = _run_blocks(params, cfg, x, None)
        logits = constrain(_logits(params, cfg, x), "batch", None, "vocab")
    if not return_aux:
        return logits
    if aux is None:
        aux = torch.zeros(2, dtype=torch.float32, device=logits.device)
    return logits, aux


# ---------------------------------------------------------------------------
# Lane-parameterized forward (float / int / fhe_sim execution of a PTQ'd LM)
# ---------------------------------------------------------------------------

def _lane_causal_mask(cfg: ModelConfig, n: int):
    """Cleartext attention structure for the lane forward (numpy bool;
    masks are public, and masked pairs are excluded from the combining
    sums).  Shares the causal/window predicate with ``_build_mask``."""
    import numpy as np

    from repro_torch.core.attention import structural_mask_predicate

    a = cfg.attention
    m = structural_mask_predicate(a.causal, a.sliding_window,
                                  np.arange(n)[:, None],
                                  np.arange(n)[None, :])
    return None if m is None else m[None, None]


def _lane_attention_kwargs(mech, qlm):
    """Integer-domain hyper-parameters for a mechanism's lane_fn, filtered
    by its signature (mechanisms accept different shift sets)."""
    import inspect

    full = {
        "gamma_shift": qlm.gamma_shift,
        "alpha_q": qlm.alpha_q,
        "signed": bool(mech.param_overrides.get("signed", False)),
        "normalize": qlm.cfg.attention.normalize,
        "scale_shift": qlm.scale_shift,
        "frac_bits": qlm.ptq.softmax_frac,
        "exp_clip": qlm.ptq.exp_clip,
    }
    accepted = inspect.signature(mech.lane_fn).parameters
    return {k: v for k, v in full.items() if k in accepted}


def apply_block_lane(qblock: dict, qlm, lane, x, *, mask=None,
                     layer_tag: str = "L0"):
    """One pre-norm block on a lane: norm → attention (via the mechanism
    registry's lane_fn) → residual → norm → MLP → residual.  Costs land
    in per-sublayer scopes on the ``fhe_sim`` lane."""
    from repro_torch.core.mechanism import (get_mechanism,
                                            resolve_mechanism_name)
    from repro_torch.nn.lane_layers import lane_linear, lane_mlp, lane_norm
    from repro_torch.quant.int_attention import lane_attention_heads

    cfg, ptq = qlm.cfg, qlm.ptq
    a = cfg.attention
    sub_mean = cfg.norm == "layernorm"
    mech = get_mechanism(resolve_mechanism_name(a))
    if mech.lane_fn is None:
        raise ValueError(f"mechanism {mech.name!r} has no lane_fn — "
                         "it cannot run on integer/encrypted lanes")

    with lane.scope(f"{layer_tag}.ln1"):
        h = lane_norm(lane, x, qblock["ln1"], ptq=ptq,
                      subtract_mean=sub_mean)
    b, n = lane.shape(h)[0], lane.shape(h)[1]
    with lane.scope(f"{layer_tag}.qkv_proj"):
        q = lane.reshape(lane_linear(lane, h, qblock["wq"], ptq=ptq),
                         (b, n, a.num_heads, a.head_dim))
        k = lane.reshape(lane_linear(lane, h, qblock["wk"], ptq=ptq),
                         (b, n, a.num_kv_heads, a.head_dim))
        v = lane.reshape(lane_linear(lane, h, qblock["wv"], ptq=ptq),
                         (b, n, a.num_kv_heads, a.head_dim))
    with lane.scope(f"{layer_tag}.attn"):
        o = lane_attention_heads(lane, mech.lane_fn, q, k, v, mask=mask,
                                 **_lane_attention_kwargs(mech, qlm))
    with lane.scope(f"{layer_tag}.out_proj"):
        o = lane_linear(lane, lane.reshape(
            o, (b, n, a.num_heads * a.head_dim)), qblock["wo"], ptq=ptq)
        x = lane.add(x, o)
    with lane.scope(f"{layer_tag}.ln2"):
        h2 = lane_norm(lane, x, qblock["ln2"], ptq=ptq,
                       subtract_mean=sub_mean)
    with lane.scope(f"{layer_tag}.mlp"):
        act = "gelu" if cfg.mlp == "mlp_gelu" else "relu"
        f = lane_mlp(lane, h2, qblock["wi"], qblock["wo_mlp"], ptq=ptq,
                     activation=act)
        x = lane.add(x, f)
    return x


def lm_forward_lane(qlm, lane, tokens):
    """End-to-end lane forward of a PTQ'd LM: tokens (b, s) cleartext
    (numpy or a tensor) → logits handle (b, s, V) on ``lane``'s device.

    On ``fhe_sim`` this is the paper's headline scenario — the whole
    block runs under the TFHE cost model, bit-exact with the ``int``
    lane, with per-layer PBS/add/cmul/bit-width scopes accumulated on
    ``lane.ctx`` (``python -m repro_torch.launch.fhe``).
    """
    from repro_torch.nn.lane_layers import lane_embed, lane_logits

    cfg = qlm.cfg
    with lane.scope("embed"):
        x = lane_embed(lane, qlm.embed, tokens)
    mask = _lane_causal_mask(cfg, lane.shape(x)[1])
    for i, qblock in enumerate(qlm.blocks):
        x = apply_block_lane(qblock, qlm, lane, x, mask=mask,
                             layer_tag=f"L{i}")
    with lane.scope("head"):
        return lane_logits(lane, x, qlm.final_norm, qlm.lm_head,
                           ptq=qlm.ptq,
                           subtract_mean=cfg.norm == "layernorm")


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
    are then always per-slot).  The hybrid family adds its zero Mamba
    carries: ``ssm`` (L, b, inner, n) in float32, ``conv`` (L, b,
    conv_dim − 1, inner) in the compute dtype.
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
    if cfg.family != "hybrid":
        return LayerState(kv=kv)
    inner, L = _mamba_inner(cfg), cfg.num_layers
    return LayerState(
        kv=kv,
        ssm=torch.zeros((L, batch, inner, cfg.ssm.state_dim),
                        dtype=torch.float32, device=dev),
        conv=torch.zeros((L, batch, cfg.ssm.conv_dim - 1, inner),
                         dtype=cfg.cdtype, device=dev))


def lm_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            states: LayerState):
    """Decode step: tokens (b, t) appended at the cursors.

    Returns (logits (b, t, V), new_states); the new state shares the KV
    storage of ``states`` (written in place) with the cursors advanced;
    its Mamba carries (hybrid) are new tensors.
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
        x, new, _ = _run_blocks(params, run_cfg, x, None,
                                states._replace(kv=_gather_paged_view(kv)))
        new = new._replace(kv=_scatter_paged_rows(kv, new.kv, t))
    else:
        x, new, _ = _run_blocks(params, cfg, x, None, states)
    return _logits(params, cfg, x), new
