"""Sharding assembly, placement, and the sharded steps over DTensor.

Port of :mod:`repro.launch.shardings`.  How (params, opt_state, batch,
decode states) map onto a mesh, so the dry-run, the trainer and the
tests place the same distribution:

  * params      — logical axes via the rules table (FSDP over ``data``,
                  TP/EP over ``model``), with the divisibility fallback:
                  no shard is ever uneven.
  * opt state   — moments mirror the param shardings; the step count is
                  replicated.
  * batch       — leading dim over ("pod", "data"), pod-major: rank
                  (p, d) holds rows [(p·D+d)·b_l, (p·D+d+1)·b_l).
  * states      — decode caches: the batch dim over ("pod", "data"); one
                  more dim over ``model``, the first model-divisible one
                  after it (the sequence dim of a KV buffer).

:func:`place` does what ``jax.device_put(tree, shardings)`` does: each
rank keeps its own shard of a host tree that every rank holds (no
communication).

The sharded steps (the reference's GSPMD program, in FSDP / ZeRO-3
form with tensor parallelism over ``model``).  Parameters and AdamW
moments live as DTensors.  The model runs on plain local tensors, on the
rank's batch rows: each parameter is gathered at use (a differentiable
``redistribute``, then ``to_local``) over the batch axes, and its
gradient comes back ``Partial`` over them, which DTensor's autograd
reduce-scatters to the parameter's placements.  AdamW updates the local
shards; the global-norm clip reduces across them.  The hand-written
kernels see plain tensors only.

Tensor-parallel compute (:func:`gather_params`): a layer whose
placements put its tensor-parallel dim on ``model`` keeps that shard and
is handed to the model as a
:class:`~repro_torch.distributed.sharding.ModelShards`, so each ``model``
rank computes its attention heads, its slice of the MLP hidden width,
its vocabulary rows of the embedding and the logits, its experts, its
RWKV-6 time-mix heads, its slice of the channel-mix hidden width and its
Mamba inner channels, between Megatron-style regions
(``distributed/sharding.py``); the loss is a vocab-parallel NLL.  A
layer may hold some entries whole although they are stored sharded (the
channel-mix ``receptance``, Mamba's ``in_proj``, whose [x | z] halves a
contiguous shard does not split): :func:`_split_plan` names them.  The
layers that compute whole on every ``model`` rank: an attention whose
query heads per rank do not fall into whole kv groups, an RWKV-6
time-mix whose heads do not divide over ``model``, and any layer whose
dim does not divide over ``model`` (``param_spec``'s fallback).  Where
``model`` divides the sequence, the no-cache forwards (the train and
prefill steps, with or without microbatches, and the remat recompute,
which takes the sequence split again) keep the norm regions
sequence-parallel (the reference's ``seq_sp``): the residual on each
rank's s/M positions, each region entered by an all-gather and left by a
reduce-scatter over the sequence, and an attention computed whole
computes only the rank's s/M query rows over the whole sequence's keys
(``core.attention.query_split``: the reference's score rows over
``model``), its weights' gradients summed over ``model``; elsewhere
(every decode step) regions all-reduce their output and such an
attention computes every row.

Global semantics the local compute keeps, so that the sharded step
equals the single-device one: the loss is the all-reduced NLL sum over
the all-reduced count of valid labels; the MoE layer's capacity, slots
and auxiliary losses are global (:mod:`repro_torch.nn.moe`).  With
microbatches, microbatch m is the reference's: the global rows
[m·B/M, (m+1)·B/M), each batch rank holding its part of them in the
global order, moved there by one all-to-all of each batch key over the
batch axes (:func:`repro_torch.distributed.sharding.global_microbatches`);
so those semantics hold within each microbatch, for every family.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.distributed.sharding import (
    ModelShards, NamedSharding, axis_sizes, batch_all_reduce, current_mesh,
    global_microbatches, is_split, model_all_gather, model_all_reduce,
    model_all_reduce_max, model_group, model_rank, param_spec, placements,
    use_mesh)
from repro_torch.distributed.sharding import batch_axes as batch_axes_for
from repro_torch.nn.module import axes_of, unbox
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _entry(axes: tuple):
    """A spec entry over ``axes``: one name, or a tuple of several (as a
    ``PartitionSpec`` normalises it)."""
    return axes[0] if len(axes) == 1 else axes


def params_shardings(boxed_struct, mesh):
    """Boxed parameter tree (Param leaves: tensors or ``meta`` stand-ins)
    -> (unboxed tree, tree of :class:`NamedSharding`)."""
    axes = axes_of(boxed_struct)
    struct = unbox(boxed_struct)
    sh = tree_map(lambda st, ax: NamedSharding(
        mesh, param_spec(ax, tuple(st.shape), mesh)), struct, axes)
    return struct, sh


def opt_shardings(opt_struct, param_shardings_tree, mesh):
    """Moments inherit the parameter shardings; the step is replicated."""
    return type(opt_struct)(step=replicated(mesh), mu=param_shardings_tree,
                            nu=param_shardings_tree)


def batch_shardings(specs: dict, mesh) -> dict:
    ba = batch_axes_for(mesh)
    sizes = axis_sizes(mesh)
    bsize = math.prod(sizes[a] for a in ba) if ba else 1
    out = {}
    for k, s in specs.items():
        if s.shape and s.shape[0] % max(bsize, 1) == 0 and ba:
            out[k] = NamedSharding(mesh, (_entry(ba),))
        else:
            out[k] = NamedSharding(mesh, ())
    return out


def state_shardings(state_struct, mesh, batch: int):
    """Decode-state shardings by the reference's shape heuristic.  The
    reference's states are all layer-stacked (L, b, ...); the port's
    caches are stacked too, but its cursors and block tables are shared
    by the layers, (b,) / (b, P).  So the batch dim is found by the
    global ``batch``: dim 1 of a leaf of ndim >= 2 whose dim 1 is
    ``batch`` (stacked), else dim 0 when it is ``batch``.  It shards over
    ("pod", "data") when divisible; the first later dim that ``model``
    divides shards over ``model``."""
    ba = batch_axes_for(mesh)
    sizes = axis_sizes(mesh)
    bsize = math.prod(sizes[a] for a in ba) if ba else 1
    msize = sizes.get("model", 1)

    def spec_for(st):
        if st is None:
            return None
        if st.dim() == 0:
            return NamedSharding(mesh, ())
        shape = tuple(st.shape)
        parts = [None] * len(shape)
        bdim = (1 if len(shape) >= 2 and shape[1] == batch
                else 0 if shape[0] == batch else None)
        if bdim is not None and ba and shape[bdim] % bsize == 0:
            parts[bdim] = _entry(ba)
        if "model" in sizes:
            start = 2 if bdim == 1 or (bdim is None and len(shape) >= 2) \
                else 1
            for i in range(start, len(shape)):
                if shape[i] % msize == 0 and shape[i] >= msize:
                    parts[i] = "model"
                    break
        while parts and parts[-1] is None:
            parts.pop()
        return NamedSharding(mesh, tuple(parts))

    return tree_map(spec_for, state_struct)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def place(tree, shardings, *, requires_grad: bool = False):
    """Put a host tree on the mesh: each leaf becomes a DTensor of its
    sharding holding a copy of this rank's shard (every rank holds the
    same tree, so no data moves between ranks).  ``requires_grad`` makes the DTensors autograd
    leaves (parameters)."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, sh):
        if t is None:
            return None
        # a copy: a replicated shard would otherwise alias the host
        # tensor, and the steps update shards in place
        dt = distribute_tensor(t.detach().to(mesh_device(sh.mesh), copy=True),
                               sh.mesh, sh.placements, src_data_rank=None)
        return dt.requires_grad_(True) if requires_grad else dt

    return tree_map(one, tree, shardings)


def local(x):
    """This rank's shard of a DTensor (a plain tensor passes through)."""
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def _on_model(p, dim: int, m: int) -> bool:
    """Is DTensor ``p``'s tensor dim ``dim`` sharded over mesh dim ``m``
    (``model``)?"""
    from torch.distributed.tensor import Shard

    pl = p.placements[m]
    return isinstance(pl, Shard) and pl.dim == dim


#: the entries of an RWKV-6 time-mix, a channel-mix and a Mamba block
_TIME_MIX = frozenset({"mu_base", "mix_lora_a", "mix_lora_b", "receptance",
                       "key", "value", "gate", "w_base", "w_lora_a",
                       "w_lora_b", "u", "output", "ln_x"})
_CHANNEL_MIX = frozenset({"mu_k", "mu_r", "key", "receptance", "value"})
_MAMBA = frozenset({"in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
                    "A_log", "D", "out_proj"})


def _split_plan(node: dict, key, m: int, heads=None):
    """How the layer ``node`` (a dict of DTensor parameters, reached by
    ``key``) computes over mesh dim ``m`` (``model``): None where it
    computes whole, else the names of its entries that are gathered whole
    over ``model`` although stored sharded there (an empty set where every
    sharded entry keeps its shard).  A layer splits where its
    tensor-parallel dims are all sharded over ``model``; ``heads`` is the
    RWKV-6 time-mix's head count, which its parameters do not carry (None:
    the time-mix computes whole)."""
    def kern(name):
        return node[name]["kernel"]

    def on(name, dim):
        leaf = node[name]
        return _on_model(leaf["kernel"] if isinstance(leaf, dict) else leaf,
                         dim, m)

    keep = frozenset()
    if key == "embed" and set(node) == {"table"}:
        return keep if on("table", 0) else None
    if key == "lm_head" and set(node) == {"kernel"}:
        return keep if _on_model(node["kernel"], 1, m) else None
    if {"wq", "wk", "wv", "wo"} <= set(node):
        if not (on("wq", 1) and on("wo", 0)):
            return None
        # a rank's h/M query heads must fall into whole kv groups
        n = kern("wq").device_mesh.shape[m]
        h, hk = kern("wq").shape[1], kern("wk").shape[1]
        h_local, group = h // n, h // hk
        return keep if h_local % group == 0 or group % h_local == 0 else None
    if set(node) == {"wi", "wo"}:
        return keep if on("wi", 1) and on("wo", 0) else None
    if set(node) == {"wg", "wu", "wd"} and kern("wg").dim() == 2:
        return keep if on("wg", 1) and on("wu", 1) and on("wd", 0) else None
    if "router" in node:
        return keep if all(on(k, 0) for k in ("wg", "wu", "wd")) else None
    if set(node) == _TIME_MIX:
        # a column shard of d/M must be whole heads of d/h columns:
        # d % M (which param_spec checks) is not enough, h % M is
        n = kern("receptance").device_mesh.shape[m]
        if heads is None or heads % n or not (
                all(on(k, 1) for k in ("receptance", "key", "value", "gate"))
                and on("output", 0)):
            return None
        return keep
    if set(node) == _CHANNEL_MIX:
        # the receptance gate multiplies the reduced value output
        # elementwise, so it is gathered whole and computed outside the
        # region (nn/ssm.py::apply_rwkv6_channelmix)
        return (frozenset({"receptance"}) if on("key", 1) and on("value", 0)
                else None)
    if set(node) == _MAMBA:
        # in_proj's out dim is [x | z], two halves of the inner width: its
        # contiguous shard is not a rank's share of either, so it is
        # gathered whole and the rank slices its two blocks
        # (nn/ssm.py::apply_mamba); the other leaves follow the inner
        # dim's shard as stored
        if not (on("conv_w", 1) and on("conv_b", 0) and on("dt_proj", 1)
                and on("A_log", 0) and on("D", 0) and on("x_proj", 0)
                and on("out_proj", 0) and on("in_proj", 1)):
            return None
        return frozenset({"in_proj"})
    return None


def gather_params(params, mesh, *, grad: bool = True, cfg=None):
    """The parameters as plain tensors for the model: each leaf whole over
    the batch axes, and over ``model`` either whole or, for a layer that
    splits (:func:`_split_plan`), this rank's shard, the layer handed as a
    :class:`~repro_torch.distributed.sharding.ModelShards` (its MoE
    ``shared`` expert decided on its own; ``whole`` names its entries
    that hold no shard over ``model``).  ``cfg``, the model's config,
    gives the RWKV-6 time-mix's head count.  With ``grad`` the gather is
    differentiable and the local gradient is declared ``Partial`` over
    the batch axes and, over ``model``, the shard (``Shard``) or
    ``Replicate`` (every model rank computed the same), so the backward
    reduce-scatters it to the parameter's placements."""
    from torch.distributed.tensor import Partial, Replicate

    names = list(mesh.mesh_dim_names)
    ba = batch_axes_for(mesh)
    m = names.index("model") if "model" in names else None
    heads = None
    if cfg is not None and cfg.family == "ssm":
        heads = cfg.attention.num_heads

    def one(p, keep: bool):
        target = [p.placements[i] if keep and i == m else Replicate()
                  for i in range(mesh.ndim)]
        full = p.redistribute(mesh, target)
        if not grad:
            return full.to_local()
        return full.to_local(grad_placements=[
            Partial() if n in ba else target[i]
            for i, n in enumerate(names)])

    def walk(node, key=None):
        if isinstance(node, (list, tuple)):
            return type(node)(walk(x) for x in node)
        if not isinstance(node, dict):
            return one(node, False)
        plan = None if m is None else _split_plan(node, key, m, heads)
        if plan is None:
            return {k: walk(node[k], k) for k in sorted(node)}
        return ModelShards(
            {k: walk(v, k) if k == "shared" else
             tree_map(lambda p, keep=k not in plan: one(p, keep), v)
             for k, v in sorted(node.items())},
            whole=[k for k, v in node.items() if k in plan or all(
                isinstance(p.placements[m], Replicate)
                for p in tree_leaves(v))])

    return walk(params)


def _vocab_split(params) -> bool:
    """Are these gathered parameters' logits this rank's vocabulary
    columns (a split ``lm_head``, or a split tied table)?"""
    return is_split(params.get("lm_head", params.get("embed")))


class _VocabNLL(torch.autograd.Function):
    """Per-token NLL of vocab-parallel logits (each ``model`` rank holds
    the vocabulary columns [lo, lo + V/M)), as lean as
    :class:`repro_torch.train.step._TokenNLL`: the maximum all-reduced
    without a gradient, then the sum of exponentials and the gold logit
    (from the rank that holds the label) all-reduced; it saves the
    compute-dtype logits and the (b, s) float32 lse, and its backward is
    softmax_local − onehot_local times g, with no (b, s, V) one-hot."""

    @staticmethod
    def forward(ctx, logits, labels, lo: int):
        lf = logits.float()
        cols = lf.shape[-1]
        mx = model_all_reduce_max(lf.amax(-1))
        # exp in place: one float32 logits-sized temporary, as
        # torch.logsumexp takes
        lse = mx + torch.log(model_all_reduce(
            (lf - mx[..., None]).exp_().sum(-1)))
        idx = labels.long() - lo
        mine = (idx >= 0) & (idx < cols)
        idx = idx.clamp(0, cols - 1)
        gold = model_all_reduce(
            torch.gather(lf, -1, idx[..., None])[..., 0] * mine)
        ctx.save_for_backward(logits, idx, mine, lse)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        logits, idx, mine, lse = ctx.saved_tensors
        grad = (torch.exp(logits.float() - lse[..., None])
                * g[..., None]).to(logits.dtype)
        grad.scatter_add_(-1, idx[..., None],
                          -(g * mine)[..., None].to(grad.dtype))
        return grad, None, None


def _token_nll(logits, labels, vocab_split: bool):
    """Per-token NLL of whole or vocab-parallel logits."""
    from repro_torch.train.step import _TokenNLL

    if not vocab_split:
        return _TokenNLL.apply(logits, labels)
    return _VocabNLL.apply(logits, labels, model_rank() * logits.shape[-1])


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------

def _sharded_loss(api, params, batch, mesh):
    """(this rank's share of the loss, global metrics).  The shares add up
    over the batch ranks to the single-device loss: the NLL of the
    rank's rows over the global count of valid labels (vocab-parallel
    where the head is split over ``model``), plus (MoE) the global
    auxiliary losses, whose gradient each rank takes for its own rows
    only (``batch_sum``)."""
    from repro_torch.train.step import _align_labels

    cfg = api.cfg
    if cfg.moe is None:
        logits = api.forward(params, batch)
    else:
        logits, aux = api.forward(params, batch, return_aux=True)
    labels = _align_labels(logits, batch["labels"])
    mask = labels >= 0
    nll = (_token_nll(logits, torch.clamp(labels, min=0),
                      _vocab_split(params)) * mask.float()).sum()
    count = torch.clamp(batch_all_reduce(mask.sum(), mesh), min=1)
    share = nll / count
    xent = batch_all_reduce(share.detach(), mesh)
    metrics = {"xent": xent}
    loss = xent
    if cfg.moe is not None:
        lb, zl = aux[0], aux[1]
        share = (share + cfg.moe.lb_loss_weight * lb
                 + cfg.moe.z_loss_weight * zl)
        loss = (xent + cfg.moe.lb_loss_weight * lb.detach()
                + cfg.moe.z_loss_weight * zl.detach())
        metrics["moe_lb"] = lb.detach()
        metrics["moe_z"] = zl.detach()
    metrics["loss"] = loss
    return share, metrics


def _replication(dt) -> int:
    """How many ranks hold each element of a DTensor's shards."""
    from torch.distributed.tensor import Shard

    return math.prod(n for n, p in zip(dt.device_mesh.shape, dt.placements)
                     if not isinstance(p, Shard))


def sharded_global_norm(grads: list, mesh) -> torch.Tensor:
    """The global L2 norm of sharded gradients: each rank's sums of
    squares (each divided by the replication of its shard), summed over
    the whole mesh, one all-reduce per mesh axis."""
    import torch.distributed as dist

    # per leaf, then one sum, as optim.adamw.global_norm adds them: at
    # mesh size 1 the two are the same arithmetic
    total = torch.sum(torch.stack([
        torch.sum(torch.square(local(g).float())) / _replication(g)
        for g in grads]))
    for name in mesh.mesh_dim_names:
        if axis_sizes(mesh)[name] > 1:
            dist.all_reduce(total, group=mesh.get_group(name))
    return torch.sqrt(total)


def make_sharded_train_step(api, opt_cfg, mesh,
                            microbatches: int = 1) -> Callable:
    """``(params, opt_state, batch) -> (params', opt_state', metrics)``
    over DTensors placed by :func:`params_shardings` /
    :func:`opt_shardings` / :func:`batch_shardings`, equal to
    :func:`repro_torch.train.step.make_train_step` on the gathered
    tensors.  Updates the shards in place.

    ``microbatches`` > 1 runs M sequential micro-steps, microbatch m the
    reference's global rows [m·B/M, (m+1)·B/M), each rank holding its
    part of them
    (:func:`~repro_torch.distributed.sharding.global_microbatches`), each
    normalised by its global count of valid labels; the gradient is
    their mean.  Over R batch ranks M·R must divide B, else the step
    raises ``ValueError``."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.optim.adamw import AdamWState, adamw_update
    from repro_torch.train.step import _unreached

    plain_cfg = dataclasses.replace(opt_cfg, grad_clip_norm=None)

    def grads_of(params, leaves, batch):
        # the backward under the mesh too: a checkpointed block's forward
        # runs again there, and its regions and the MoE's global slots
        # read the mesh
        with use_mesh(mesh):
            share, metrics = _sharded_loss(
                api, gather_params(params, mesh, cfg=api.cfg), batch, mesh)
            grads = torch.autograd.grad(share, leaves, allow_unused=True)
        unreached = _unreached(params, batch)
        out = []
        for p, g in zip(leaves, grads):
            if g is None:
                if id(p) not in unreached:
                    raise RuntimeError(f"a parameter of shape "
                                       f"{tuple(p.shape)} does not reach "
                                       "the loss")
                g = torch.zeros_like(p)
            if tuple(g.placements) != tuple(p.placements):
                # a replicated parameter's gradient stays Partial
                g = g.redistribute(mesh, p.placements)
            out.append(g)
        return out, metrics

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        if microbatches == 1:
            grads, metrics = grads_of(params, leaves,
                                      {k: local(v) for k, v in batch.items()})
        else:
            splits = {k: global_microbatches(v, microbatches, mesh)
                      for k, v in batch.items()}
            acc, ms = None, []
            for i in range(microbatches):
                g, m = grads_of(params, leaves,
                                {k: v[i] for k, v in splits.items()})
                g = [x.float() for x in g]
                acc = g if acc is None else [a + x for a, x in zip(acc, g)]
                ms.append(m)
            grads = [a / microbatches for a in acc]
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        with torch.no_grad():
            scale = 1.0
            if opt_cfg.grad_clip_norm is not None:
                norm = sharded_global_norm(grads, mesh)
                scale = torch.clamp(opt_cfg.grad_clip_norm
                                    / torch.clamp(norm, min=1e-12), max=1.0)
                metrics["grad_norm"] = norm
            step = local(opt_state.step)
            state = AdamWState(step, tree_map(local, opt_state.mu),
                               tree_map(local, opt_state.nu))
            _, new_state, opt_metrics = adamw_update(
                tree_unflatten(params, [local(g) * scale for g in grads]),
                state, tree_map(local, params), plain_cfg)
        new_step = new_state.step
        if isinstance(opt_state.step, DTensor):
            new_step = DTensor.from_local(new_step, mesh,
                                          [Replicate()] * mesh.ndim)
        return (params, AdamWState(new_step, opt_state.mu, opt_state.nu),
                {**metrics, **opt_metrics})

    return train_step


# ---------------------------------------------------------------------------
# the sharded serving steps (the dry-run's prefill and decode cells)
# ---------------------------------------------------------------------------

def _batch_placements(mesh) -> list:
    return placements((_entry(batch_axes_for(mesh)),), mesh)


def make_sharded_prefill_step(api, mesh, batch_chunks: int = 8) -> Callable:
    """``(params, batch) -> last-position logits`` over DTensor
    parameters and a batch sharded over ("pod", "data"): the gathered
    parameters (split layers computed tensor-parallel),
    :func:`repro_torch.train.step.make_prefill_step` on the rank's rows
    under the mesh, each chunk's last-position logits all-gathered over
    ``model`` where they are vocab-parallel; the logits a batch-sharded
    DTensor.  Under sequence parallelism the last position lies on the
    last ``model`` rank's slice; the final norm's output is gathered over
    the sequence into the head, so every rank's logits hold it."""
    from torch.distributed.tensor import DTensor

    from repro_torch.train.step import make_prefill_step

    @torch.no_grad()
    def prefill_step(params, batch):
        gp = gather_params(params, mesh, grad=False, cfg=api.cfg)
        forward = api.forward
        if _vocab_split(gp):
            def forward(p, b):
                return model_all_gather(api.forward(p, b)[:, -1:])
        with use_mesh(mesh):
            out = make_prefill_step(api._replace(forward=forward),
                                    batch_chunks)(
                gp, {k: local(v) for k, v in batch.items()})
        return DTensor.from_local(out, mesh, _batch_placements(mesh))

    return prefill_step


def _split_layer(params, kind):
    """The first split layer of a gathered tree that ``kind`` accepts
    (every such layer of a model splits alike), or None."""
    if isinstance(params, dict):
        if is_split(params) and kind(params):
            return params
        found = (_split_layer(params[k], kind) for k in sorted(params))
    elif isinstance(params, (list, tuple)):
        found = (_split_layer(x, kind) for x in params)
    else:
        return None
    return next((f for f in found if f is not None), None)


def _kv_heads_of(attn, mesh):
    """(first, count, order) of a split attention's decode cache: this
    rank's kv heads, and where each of the model's kv heads lies in the
    ranks' heads gathered in rank order (from the first rank that holds
    it)."""
    from repro_torch.core.attention import split_kv_heads

    with use_mesh(mesh):
        spans = [split_kv_heads(attn, r)
                 for r in range(axis_sizes(mesh)["model"])]
        first, count = spans[model_rank()]
    order = []
    for j in range(spans[-1][0] + count):
        r = next(r for r, (f, _) in enumerate(spans) if f <= j < f + count)
        order.append(r * count + j - spans[r][0])
    return first, count, order


def _state_splits(params, mesh) -> dict:
    """Which decode-state leaves each ``model`` rank holds a part of:
    ``{path: (dim, span)}``, ``span`` the (first, count, order) of
    :func:`_kv_heads_of` or None for the rank's contiguous 1/M of dim
    ``dim`` (gathered back in rank order).  A split attention's cache
    holds the kv heads its query heads attend, a split RWKV-6 time-mix's
    WKV state (L, b, h, n, n) its h/M heads, a split Mamba block's
    carries its c/M channels (``ssm`` (L, b, c, n), ``conv`` (L, b,
    k − 1, c)); the last tokens ``tm_x`` / ``cm_x`` stay whole.  Empty at
    one ``model`` rank."""
    if model_group(mesh) is None:
        return {}
    out = {}
    attn = _split_layer(params, lambda p: "wq" in p)
    if attn is not None:
        span = _kv_heads_of(attn, mesh)
        out[(".kv", ".k")] = out[(".kv", ".v")] = (-2, span)
    if _split_layer(params, lambda p: "ln_x" in p) is not None:
        out[(".wkv",)] = (-3, None)
    if _split_layer(params, lambda p: "A_log" in p) is not None:
        out[(".ssm",)] = (-2, None)
        out[(".conv",)] = (-1, None)
    return out


def _state_part(s, dim: int, span):
    """This rank's part of a whole decode-state leaf (:func:`_state_splits`)."""
    if span is not None:
        return s.narrow(dim, span[0], span[1])
    n = s.shape[dim] // axis_sizes(current_mesh())["model"]
    return s.narrow(dim, model_rank() * n, n)


def _state_whole(n, dim: int, span):
    """The whole leaf from every rank's part (a collective)."""
    n = model_all_gather(n, dim=dim)
    return n if span is None else n.index_select(
        dim, torch.tensor(span[2], device=n.device))


def make_sharded_serve_step(api, mesh) -> Callable:
    """``(params, tokens, states, batch) -> (next tokens, logits,
    states')``: the decode states gathered over ``model`` to the rank's
    batch rows, :func:`repro_torch.train.step.make_serve_step` under the
    mesh (split layers computed tensor-parallel; each rank's part of the
    states of its split layers, :func:`_state_splits`, and the new states'
    parts all-gathered over ``model``), the
    last position's logits all-gathered over ``model`` before the
    argmax where they are vocab-parallel, and the new states put back in
    each state's sharding."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.tree import tree_map_with_path

    def rows_only(dt):
        return [p if isinstance(p, Shard) and name in batch_axes_for(mesh)
                else Replicate()
                for name, p in zip(mesh.mesh_dim_names, dt.placements)]

    @torch.no_grad()
    def serve_step(params, tokens, states, batch=None):
        gp = gather_params(params, mesh, grad=False, cfg=api.cfg)
        splits = _state_splits(gp, mesh)

        def mine(path, s):
            if s is None:
                return None
            s = s.redistribute(mesh, rows_only(s)).to_local()
            if path in splits:
                s = _state_part(s, *splits[path])
            return s

        with use_mesh(mesh):
            logits, new = api.step(
                gp, local(tokens), tree_map_with_path(mine, states),
                None if batch is None else {k: local(v)
                                            for k, v in batch.items()})
            logits = logits[:, -1:]
            if _vocab_split(gp):
                logits = model_all_gather(logits)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)

            def back(path, n):
                if n is None:
                    return None
                if path in splits:
                    n = _state_whole(n, *splits[path])
                return n

            new = tree_map_with_path(back, new)

        def put(n, s):
            if s is None:
                return None
            return DTensor.from_local(n, mesh, rows_only(s)).redistribute(
                mesh, s.placements)

        bp = _batch_placements(mesh)
        return (DTensor.from_local(nxt, mesh, bp),
                DTensor.from_local(logits, mesh, bp),
                tree_map(put, new, states))

    return serve_step
