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
form).  Parameters and AdamW moments live as DTensors.  The model runs
unchanged on plain local tensors, on the rank's batch rows: each
parameter is gathered at use (a differentiable ``redistribute`` to
``Replicate``, then ``to_local``), its gradient comes back ``Partial``
over the batch axes and ``Replicate`` over ``model`` (every model rank
computed the same rows), and DTensor's autograd reduce-scatters it to
the parameter's placements.  AdamW updates the local shards; the
global-norm clip reduces across them.  The hand-written kernels see
plain tensors only.  Tensor-parallel *compute* (heads / mlp / experts
split over ``model``) is not done: every model rank computes the whole
layer (ROADMAP queue 1 item [7b]).

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
    NamedSharding, axis_sizes, batch_all_reduce, global_microbatches,
    param_spec, placements, use_mesh)
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


def gather_params(params, mesh, *, grad: bool = True):
    """Each parameter whole on every rank, as plain tensors.  With
    ``grad`` the gather is differentiable and the local gradient is
    declared ``Partial`` over the batch axes and ``Replicate`` over the
    others, so the backward reduce-scatters it to the shard."""
    from torch.distributed.tensor import Partial, Replicate

    ba = batch_axes_for(mesh)
    repl = [Replicate()] * mesh.ndim
    gp = [Partial() if n in ba else Replicate()
          for n in mesh.mesh_dim_names]

    def one(p):
        full = p.redistribute(mesh, repl)
        return full.to_local(grad_placements=gp) if grad else full.to_local()

    return tree_map(one, params)


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------

def _sharded_loss(api, params, batch, mesh):
    """(this rank's share of the loss, global metrics).  The shares add up
    over the batch ranks to the single-device loss: the NLL of the
    rank's rows over the global count of valid labels, plus (MoE) the
    global auxiliary losses, whose gradient each rank takes for its own
    rows only (``batch_sum``)."""
    from repro_torch.train.step import _align_labels, _TokenNLL

    cfg = api.cfg
    if cfg.moe is None:
        logits = api.forward(params, batch)
    else:
        logits, aux = api.forward(params, batch, return_aux=True)
    labels = _align_labels(logits, batch["labels"])
    mask = labels >= 0
    nll = (_TokenNLL.apply(logits, torch.clamp(labels, min=0))
           * mask.float()).sum()
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
        with use_mesh(mesh):
            share, metrics = _sharded_loss(api, gather_params(params, mesh),
                                           batch, mesh)
        unreached = _unreached(params, batch)
        out = []
        for p, g in zip(leaves, torch.autograd.grad(share, leaves,
                                                    allow_unused=True)):
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
    parameters, :func:`repro_torch.train.step.make_prefill_step` on the
    rank's rows, the logits a batch-sharded DTensor."""
    from torch.distributed.tensor import DTensor

    from repro_torch.train.step import make_prefill_step

    inner = make_prefill_step(api, batch_chunks)

    @torch.no_grad()
    def prefill_step(params, batch):
        out = inner(gather_params(params, mesh, grad=False),
                    {k: local(v) for k, v in batch.items()})
        return DTensor.from_local(out, mesh, _batch_placements(mesh))

    return prefill_step


def make_sharded_serve_step(api, mesh) -> Callable:
    """``(params, tokens, states, batch) -> (next tokens, logits,
    states')``: the decode states gathered over ``model`` to the rank's
    batch rows, :func:`repro_torch.train.step.make_serve_step` on them,
    and the new states put back in each state's sharding."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.train.step import make_serve_step

    inner = make_serve_step(api)

    def rows_only(dt):
        return [p if isinstance(p, Shard) and name in batch_axes_for(mesh)
                else Replicate()
                for name, p in zip(mesh.mesh_dim_names, dt.placements)]

    @torch.no_grad()
    def serve_step(params, tokens, states, batch=None):
        local_states = tree_map(
            lambda s: None if s is None else
            s.redistribute(mesh, rows_only(s)).to_local(), states)
        nxt, logits, new = inner(
            gather_params(params, mesh, grad=False), local(tokens),
            local_states,
            None if batch is None else {k: local(v)
                                        for k, v in batch.items()})

        def back(n, s):
            if s is None:
                return None
            return DTensor.from_local(n, mesh, rows_only(s)).redistribute(
                mesh, s.placements)

        bp = _batch_placements(mesh)
        return (DTensor.from_local(nxt, mesh, bp),
                DTensor.from_local(logits, mesh, bp),
                tree_map(back, new, states))

    return serve_step
