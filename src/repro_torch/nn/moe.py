"""Mixture-of-Experts FFN with capacity-bounded dispatch.

Port of :mod:`repro.nn.moe`.  Tokens are routed with top-k gating, then
placed into a dense ``(experts, capacity, d)`` buffer (GShard-style,
capacity-dropped), so the expert compute is three batched matrix
products (``torch.bmm``); the outputs are gathered back and combined
with the gates.  The buffer holds ``capacity_factor · top_k · tokens``
rows, the order of one FFN activation.

Determinism: every kept (expert, position) pair is unique, so the
dispatch is a plain ``index_put_`` (no accumulation): dropped
assignments go to an overflow row past the capacity, which is cut off.
A token's ``top_k`` contributions are combined by a sum over a
``(tokens, top_k, d)`` view (``flat_token`` is token-major), not by a
scatter-add, whose atomic order on CUDA would differ between runs.  No
step reads a value back to the host, so the layer runs inside a CUDA
graph.

Returns the Switch-Transformer load-balancing and router-z auxiliary
losses and the dropped fraction (:class:`MoEAux`).

Under a mesh (:func:`repro_torch.distributed.sharding.use_mesh`) the
tokens are this rank's rows of the global batch, and the layer keeps
the single-device semantics of the whole batch: the capacity counts
the global tokens, an assignment's slot is its position in the global
token order (the one-hot cumsum offset by the per-expert counts of the
lower batch ranks, an all-gather of an (E,) vector), and the auxiliary
losses and the dropped fraction come from sums over the batch ranks.

Expert-parallel over ``model`` (parameters handed as a
:class:`~repro_torch.distributed.sharding.ModelShards`, the expert
stacks this rank's E/M experts): the router, top-k, capacity, slots and
auxiliary losses stay global and are computed alike on every ``model``
rank (the global E is the router's width); every rank builds the same
(E, C, d) buffer of its rows, runs its experts' products on its slice of
it, and combines the assignments its experts took.  That partial and
the shared expert's row-parallel partial leave the region together
(one all-reduce, or one reduce-scatter over the sequence of a
sequence-parallel stream); the tokens and the gates enter it, so that
the router and the layer's input get the gradient of every rank's
experts.
"""

from __future__ import annotations

import functools
import operator
from typing import NamedTuple

import torch

from repro_torch.distributed.sharding import (
    batch_all_gather, batch_all_reduce, batch_index, batch_sum, constrain,
    current_mesh, into_model, into_region, is_split, model_rank,
    own_positions, region_exit)
from repro_torch.nn.init import truncated_normal
from repro_torch.nn.linear import apply_dense, dense_axes, init_dense
from repro_torch.nn.mlp import (_ACT, apply_gated_mlp, gated_mlp_axes,
                                init_gated_mlp)


class MoEAux(NamedTuple):
    load_balance_loss: torch.Tensor
    router_z_loss: torch.Tensor
    dropped_fraction: torch.Tensor


def init_moe(gen: torch.Generator, embed_dim: int, expert_hidden_dim: int,
             num_experts: int, *, shared_hidden_dim: int = 0,
             shared_gate: bool = False, dtype=torch.float32,
             device=None) -> dict:
    """Router (float32, as the reference's), the expert-stacked gated MLP
    (leading expert axis) and the optional shared expert and its gate."""
    kw = dict(dtype=dtype, device=device)
    params = {
        "router": init_dense(gen, (embed_dim,), (num_experts,),
                             dtype=torch.float32, device=device),
        "wg": _stack_expert(gen, num_experts, embed_dim, expert_hidden_dim,
                            **kw),
        "wu": _stack_expert(gen, num_experts, embed_dim, expert_hidden_dim,
                            **kw),
        "wd": _stack_expert(gen, num_experts, expert_hidden_dim, embed_dim,
                            **kw),
    }
    if shared_hidden_dim > 0:
        params["shared"] = init_gated_mlp(gen, embed_dim, shared_hidden_dim,
                                          **kw)
        if shared_gate:
            params["shared_gate"] = init_dense(gen, (embed_dim,), (1,), **kw)
    return params


def moe_axes(*, shared_hidden_dim: int = 0,
             shared_gate: bool = False) -> dict:
    """Logical axes of :func:`init_moe`'s tree: the expert stacks lead
    with ``"expert"``."""
    axes = {
        "router": dense_axes(("embed",), (None,)),
        "wg": {"kernel": ("expert", "embed", "mlp")},
        "wu": {"kernel": ("expert", "embed", "mlp")},
        "wd": {"kernel": ("expert", "mlp", "embed")},
    }
    if shared_hidden_dim > 0:
        axes["shared"] = gated_mlp_axes()
        if shared_gate:
            axes["shared_gate"] = dense_axes(("embed",), (None,))
    return axes


def _stack_expert(gen: torch.Generator, num_experts: int, in_dim: int,
                  out_dim: int, *, dtype, device) -> dict:
    """``num_experts`` independent dense kernels stacked on a leading
    expert axis: (E, in, out), each drawn as ``init_dense`` draws one."""
    return {"kernel": truncated_normal(gen, (num_experts, in_dim, out_dim),
                                       in_dim ** -0.5, dtype=dtype,
                                       device=device)}


def _router_probs(params: dict, x: torch.Tensor, *,
                  router_softmax: bool = True):
    logits = apply_dense(params["router"], x.float(), 1)
    if router_softmax:
        probs = torch.softmax(logits, dim=-1)
    else:
        probs = torch.sigmoid(logits)
    return logits, probs


def capacity(top_k: int, capacity_factor: float, n_tok: int,
             num_experts: int) -> int:
    """Rows per expert: ``int(max(top_k, cf·top_k·T/E))``, capped at T
    (an expert cannot take more than every token)."""
    c = int(max(top_k, capacity_factor * top_k * n_tok / num_experts))
    return min(c, n_tok)


def apply_moe(params: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, activation: str = "silu",
              normalize_topk: bool = True, router_softmax: bool = True,
              compute_dtype=None):
    """MoE forward. x: (batch, seq, d) -> ((batch, seq, d), MoEAux).

    Dispatch: top-k routing -> position within each expert by a one-hot
    cumulative sum over the token-major (token, k) assignments -> the
    (E, C, d) buffer -> batched expert products -> gather + gated
    combine (+ the shared expert, gated by a sigmoid when it has one).
    """
    b, s, d = x.shape
    n_tok = b * s
    tokens = x.reshape(n_tok, d)
    # the global expert count; a split layer holds E/M of the experts
    num_experts = params["router"]["kernel"].shape[-1]
    split = is_split(params)
    local_experts = params["wg"]["kernel"].shape[0]
    lo = model_rank() * local_experts if split else 0
    dev = x.device
    # under a mesh of several batch ranks the rows are this rank's block
    # of the global batch: capacity, slots and the auxiliary losses are
    # the global ones (one batch rank holds the whole batch: no mesh)
    mesh = current_mesh()
    if mesh is not None and batch_index(mesh)[1] == 1:
        mesh = None
    n_global = n_tok * (batch_index(mesh)[1] if mesh is not None else 1)

    logits, probs = _router_probs(params, tokens,
                                  router_softmax=router_softmax)
    gate_vals, expert_ids = torch.topk(probs, top_k, dim=-1)   # (T, k)
    if normalize_topk:
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(-1, keepdim=True), min=1e-9)

    cap = capacity(top_k, capacity_factor, n_global, num_experts)

    flat_expert = expert_ids.reshape(-1)                        # (T·k,)
    flat_gate = gate_vals.reshape(-1)
    flat_token = torch.arange(n_tok, device=dev).repeat_interleave(top_k)

    # position of each assignment within its expert: one-hot cumsum
    onehot = (flat_expert[:, None] == torch.arange(
        num_experts, device=dev)[None]).long()                  # (T·k, E)
    pos_in_expert = (torch.cumsum(onehot, dim=0) - 1) * onehot
    flat_pos = pos_in_expert.sum(-1)                            # (T·k,)
    if mesh is not None:
        # a slot is the position in the global token order: offset by
        # the assignments of the lower batch blocks
        counts = batch_all_gather(onehot.sum(0), mesh)          # (R, E)
        flat_pos = flat_pos + counts[:batch_index(mesh)[0]].sum(0)[
            flat_expert]
    keep = flat_pos < cap                                       # drop mask
    if mesh is None:
        dropped = 1.0 - keep.float().mean()
    else:
        dropped = 1.0 - (batch_all_reduce(keep.sum(), mesh).float()
                         / (n_global * top_k))

    cdt = compute_dtype or x.dtype
    # the (E, C, d) buffer; a dropped assignment lands on the overflow
    # row C, which is cut off, so every write below is to its own row
    buf = torch.zeros((num_experts, cap + 1, d), dtype=cdt, device=dev)
    buf[flat_expert, torch.where(keep, flat_pos, cap)] = (
        into_region(params, tokens)[flat_token].to(cdt))
    buf = constrain(buf[lo:lo + local_experts, :cap], "expert", None, None)

    # expert compute: the gated MLP batched over the expert axis
    wg = params["wg"]["kernel"].to(cdt)
    wu = params["wu"]["kernel"].to(cdt)
    wd = params["wd"]["kernel"].to(cdt)
    h = _ACT[activation](torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    h = constrain(h, "expert", None, None)
    out_buf = torch.bmm(h, wd)                                  # (E, C, d)
    out_buf = constrain(out_buf, "expert", None, None)

    # gather back and combine with the gates, token by token (a split
    # layer: the assignments its experts took)
    safe_pos = torch.where(keep, flat_pos, cap - 1)
    taken = keep
    if split:
        taken = keep & (flat_expert >= lo) & (flat_expert < lo
                                               + local_experts)
    gathered = out_buf[(flat_expert - lo).clamp(0, local_experts - 1),
                       safe_pos]                                # (T·k, d)
    gate = into_region(params, flat_gate)
    gathered = gathered * (gate.to(cdt) * taken.to(cdt))[:, None]
    combined = gathered.view(n_tok, top_k, d).sum(1)

    # partial sums over the model ranks, reduced once, and whole terms
    partial, whole = ([combined], []) if split else ([], [combined])
    if "shared" in params:
        shared_split = is_split(params["shared"])
        shared_out = apply_gated_mlp(params["shared"], tokens,
                                     activation=activation, compute_dtype=cdt,
                                     reduce=False)
        if "shared_gate" in params:
            g = torch.sigmoid(apply_dense(params["shared_gate"], tokens, 1,
                                          cdt))
            shared_out = shared_out * (into_model(g) if shared_split else g)
        (partial if shared_split else whole).append(shared_out)
    out = None
    if partial:
        out = region_exit(functools.reduce(operator.add, partial).reshape(
            b, s, d))
    if whole:
        # a term computed whole, at the rank's positions of a
        # sequence-parallel stream when the experts' partial left there
        w = functools.reduce(operator.add, whole).reshape(b, s, d)
        out = w if out is None else out + own_positions(w, out.shape[1])

    # auxiliary losses (Switch Transformer): the fraction of tokens whose
    # top-1 choice is each expert, against the mean router probability
    top1 = (expert_ids[:, 0][:, None] == torch.arange(
        num_experts, device=dev)[None]).float()
    lse2 = torch.logsumexp(logits, dim=-1).square()
    if mesh is None:
        me, ce, z_loss = top1.mean(0), probs.mean(0), lse2.mean()
    else:
        # means over the global batch: sums over the batch ranks, each
        # rank's gradient that of its own rows (batch_sum)
        me = batch_sum(top1.sum(0), mesh) / n_global
        ce = batch_sum(probs.sum(0), mesh) / n_global
        z_loss = batch_sum(lse2.sum(), mesh) / n_global
    lb_loss = num_experts * (me * ce).sum()
    aux = MoEAux(lb_loss, z_loss, dropped)
    return out.to(x.dtype), aux
