"""Logical-axis -> mesh-axis sharding rules and helpers, over DTensor.

Port of :mod:`repro.distributed.sharding`.  Parameters and activations
carry *logical* axis names ("embed", "heads", "vocab", "expert",
"batch", "seq", ...).  A rules table maps each logical name to mesh axes
(or none = replicated), so ten architectures share one distribution
layer: a parallelism strategy is a rules-table edit, not a model edit.

Axis roles:
  * ``pod``   — pure data parallelism across pods
  * ``data``  — FSDP: batch sharding + parameter / optimizer-state sharding
  * ``model`` — tensor parallelism (heads / mlp / vocab / experts) and
                sequence parallelism for activations in norm regions

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (or, for the
spec functions alone, an :class:`AbstractMesh`, which needs no process
group).  A spec is a tuple with one entry per leading tensor dim:
``None``, one mesh axis name, or a tuple of names (the first the major
one), trailing ``None`` entries trimmed, as a ``PartitionSpec`` prints.
:func:`placements` turns a spec into DTensor placements, one per mesh
dim; a tensor dim over two mesh axes takes ``Shard(dim)`` on each, in
mesh order (major first), which is the reference's layout.

:func:`constrain` redistributes a DTensor activation to its logical
layout and returns any other tensor, and every tensor when no mesh is
active, unchanged.  The port's sharded steps
(:mod:`repro_torch.launch.shardings`) run the model on plain local
tensors, so their ``constrain`` calls are no-ops.

Tensor-parallel regions over ``model`` (Megatron form, on plain
tensors): the sharded steps hand a layer whose parameters they keep
sharded over ``model`` as a :class:`ModelShards`; its input enters the
region through :func:`into_model` (the identity forward, the gradient
all-reduced over ``model`` backward) and its partial output leaves it
through :func:`out_of_model` (all-reduced forward, the identity
backward).  With no mesh, or one ``model`` rank, both are the identity.

Sequence-parallel norm regions (the reference's ``seq_sp``): where
:func:`seq_split` holds (``activation_spec`` shards the sequence over
``model``, which has more than one rank), a model's no-cache forward runs
under :func:`seq_parallel`, and its residual stream, adds and norms lie
on (rows, s/M, d), each ``model`` rank its s/M positions (the whole
parameters applied there through :func:`at_positions`).  A region is
entered by :func:`enter_seq` (an all-gather over the sequence) and a
split layer leaves it by :func:`region_exit` (a reduce-scatter over the
sequence, which replaces :func:`out_of_model`'s all-reduce); a layer
computed whole returns to the rank's positions by :func:`own_positions`,
except an attention: one computed whole computes only the rank's query
rows over the whole sequence's keys
(:func:`repro_torch.core.attention.query_split`), its output already at
the rank's positions and its weights' gradients summed over ``model``.
Outside :func:`seq_parallel` (a sequence that does not divide over
``model`` or is shorter than M, every decode step) :func:`region_exit`
all-reduces and the other two are the identity.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import NamedTuple, Tuple

import torch

# ---------------------------------------------------------------------------
# Rules tables
# ---------------------------------------------------------------------------

# Parameter logical axes.  FSDP ("data") shards one large dim of each weight;
# TP ("model") shards heads/mlp/vocab/expert dims.
PARAM_RULES = {
    "embed": ("data",),            # d_model dim of weights -> FSDP
    "heads": ("model",),           # query-head dim -> TP
    "kv_heads": ("model",),        # kv-head dim -> TP
    "head_dim": (),                # never sharded
    "mlp": ("model",),             # FFN hidden -> TP
    "heads_mlp": ("model",),       # fused head*dim projections (ssm/rwkv)
    "vocab": ("model",),           # embedding/vocab -> TP
    "expert": ("model",),          # MoE expert axis -> EP (over model)
    "layers": (),                  # stacked-scan layer axis
    None: (),
}

# Activation logical axes.
ACT_RULES = {
    "batch": ("pod", "data"),      # batch -> DP across pod×data
    "batch_heads": ("pod", "data", "model"),  # merged b×h dim (blocked attn)
    "seq": (),                     # sequence replicated by default
    "seq_sp": ("model",),          # sequence-parallel regions
    "embed": (),                   # d_model on activations: replicated
    "heads": ("model",),           # per-head activations -> TP
    "kv_heads": ("model",),
    "head_dim": (),
    "mlp": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    None: (),
}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Mesh axes and sizes without devices or a process group (the
    counterpart of ``jax.sharding.AbstractMesh``): enough for the spec
    functions, e.g. on the production (16, 16) mesh from one process."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a DeviceMesh or an AbstractMesh."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return dict(zip(names, tuple(mesh.shape)))


class NamedSharding(NamedTuple):
    """A spec on a mesh (the counterpart of ``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)


class _ShardingCtx(threading.local):
    def __init__(self):
        self.mesh = None
        self.param_rules = dict(PARAM_RULES)
        self.act_rules = dict(ACT_RULES)
        self.seq = False       # the residual stream split over the sequence


_CTX = _ShardingCtx()


@contextlib.contextmanager
def use_mesh(mesh, *, param_rules=None, act_rules=None):
    """Activate a mesh + rules for this thread; the previous ones come
    back on exit."""
    prev = (_CTX.mesh, _CTX.param_rules, _CTX.act_rules)
    _CTX.mesh = mesh
    if param_rules is not None:
        _CTX.param_rules = dict(param_rules)
    if act_rules is not None:
        _CTX.act_rules = dict(act_rules)
    try:
        yield mesh
    finally:
        _CTX.mesh, _CTX.param_rules, _CTX.act_rules = prev


def current_mesh():
    return _CTX.mesh


def _trim(parts: list) -> tuple:
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _part_size(part, sizes: dict) -> int:
    names = part if isinstance(part, tuple) else (part,)
    return math.prod(sizes[n] for n in names)


def _spec_from_axes(axes, rules, sizes: dict) -> tuple:
    parts = []
    used = set()
    for name in axes:
        # keep only axes present in this mesh and not already used
        eligible = tuple(a for a in rules.get(name, ())
                         if a in sizes and a not in used)
        used.update(eligible)
        if not eligible:
            parts.append(None)
        elif len(eligible) == 1:
            parts.append(eligible[0])
        else:
            parts.append(eligible)
    return _trim(parts)


def param_spec(axes, shape=None, mesh=None) -> tuple:
    """Spec for a parameter with logical ``axes``.  With ``shape``,
    sharded dims that do not divide evenly fall back to replication, one
    dim at a time (so the port never makes an uneven shard)."""
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        return ()
    sizes = axis_sizes(mesh)
    spec = _spec_from_axes(axes, _CTX.param_rules, sizes)
    if shape is None:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, part in enumerate(parts):
        if part is not None and shape[i] % _part_size(part, sizes):
            parts[i] = None
    return _trim(parts)


def param_sharding(axes_tree, arr_tree, mesh=None):
    """Tree of :class:`NamedSharding` for a plain parameter tree (tensors
    or anything with a ``shape``) and its axes tree."""
    from repro_torch.tree import tree_map

    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        raise ValueError("param_sharding needs a mesh (use_mesh or mesh=)")
    return tree_map(
        lambda arr, axes: NamedSharding(mesh, param_spec(axes, arr.shape,
                                                         mesh)),
        arr_tree, axes_tree)


def activation_spec(shape, axes, mesh=None) -> tuple:
    """The spec :func:`constrain` gives a tensor of ``shape``: the
    activation rules, dims whose size does not divide their mesh axes
    replicated *per dim*, so a later logical axis mapping to the same
    mesh axis gets its chance (("heads", "seq_sp") both -> "model": a
    40-head tensor on a 16-way axis shards its seq dim instead)."""
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        return ()
    sizes = axis_sizes(mesh)
    parts = []
    used = set()
    for i, name in enumerate(axes):
        eligible = tuple(a for a in _CTX.act_rules.get(name, ())
                         if a in sizes and a not in used)
        if eligible and i < len(shape):
            size = math.prod(sizes[a] for a in eligible)
            if shape[i] % size == 0 and shape[i] >= size:
                used.update(eligible)
                parts.append(eligible[0] if len(eligible) == 1
                             else eligible)
                continue
        parts.append(None)
    return _trim(parts)


def constrain(x, *axes):
    """Lay a DTensor activation out by its logical ``axes`` (see
    :func:`activation_spec`).  No-op when no mesh is active and on a
    plain tensor (the model computing on local shards)."""
    mesh = _CTX.mesh
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements(
        activation_spec(tuple(x.shape), axes, mesh), mesh))


def batch_spec(mesh=None) -> tuple:
    """Spec of a (batch, ...) input."""
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        return ()
    return _spec_from_axes(("batch",), _CTX.act_rules, axis_sizes(mesh))


def placements(spec, mesh) -> list:
    """DTensor placements, one per mesh dim, of ``spec``: ``Shard(i)`` on
    each mesh axis named by tensor dim ``i``'s entry, ``Replicate()`` on
    the others.  A dim over several mesh axes must name them in mesh
    order (the first the major one), which is DTensor's nesting."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_sizes(mesh))
    out = [Replicate() for _ in names]
    for dim, part in enumerate(spec):
        if part is None:
            continue
        group = part if isinstance(part, tuple) else (part,)
        order = [names.index(a) for a in group]
        if order != sorted(order):
            raise ValueError(f"spec entry {part} is not in mesh order "
                             f"{tuple(names)}")
        for i in order:
            out[i] = Shard(dim)
    return out


def batch_axes(mesh) -> tuple:
    """The mesh's batch axes, ("pod", "data") where present."""
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))


def batch_index(mesh) -> Tuple[int, int]:
    """(this rank's block of batch rows, the number of blocks): the
    pod-major index over the batch axes, as the reference lays out a
    dim sharded over ("pod", "data")."""
    coord = mesh.get_coordinate()
    names = list(mesh.mesh_dim_names)
    idx, count = 0, 1
    for a in batch_axes(mesh):
        i = names.index(a)
        idx = idx * mesh.shape[i] + coord[i]
        count *= mesh.shape[i]
    return idx, count


def batch_all_reduce(x, mesh):
    """The sum of ``x`` over the batch axes of ``mesh``: one all-reduce
    per axis, on that axis's process sub-group.  Returns a new tensor."""
    import torch.distributed as dist

    out = x.clone()
    for a in batch_axes(mesh):
        if axis_sizes(mesh)[a] > 1:
            dist.all_reduce(out, group=mesh.get_group(a))
    return out


def batch_sum(x, mesh):
    """The sum of ``x`` over the batch ranks, differentiable with the
    identity backward: the gradient each rank receives is that of its
    own contribution, so the ranks' gradients add up to the gradient of
    the global quantity (the MoE's load-balance and z losses)."""
    total = batch_all_reduce(x.detach(), mesh)
    return x + (total - x.detach())


def batch_all_gather(x, mesh):
    """Stack ``x`` from every batch rank: (blocks, *x.shape), block order
    pod-major as :func:`batch_index` numbers them."""
    import torch
    import torch.distributed as dist

    out = x[None]
    # the minor axis first: each gather stacks whole lower-axis blocks
    for a in reversed(batch_axes(mesh)):
        n = axis_sizes(mesh)[a]
        if n == 1:
            continue
        parts = [torch.empty_like(out) for _ in range(n)]
        dist.all_gather(parts, out.contiguous(), group=mesh.get_group(a))
        out = torch.cat(parts, dim=0)
    return out


def batch_group(mesh):
    """The process group over the batch axes of ``mesh``, its ranks in
    :func:`batch_index` order, or None where the axes hold one rank.  Two
    batch axes of more than one rank each (pod and data) are flattened
    into one sub-mesh, which the mesh keeps for later calls."""
    axes = tuple(a for a in batch_axes(mesh) if axis_sizes(mesh)[a] > 1)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def global_microbatches(x, microbatches: int, mesh) -> list:
    """This rank's rows of each of ``microbatches`` global microbatches
    of a batch key ``x``: a DTensor sharded over the batch axes (as
    :func:`repro_torch.launch.shardings.batch_shardings` places a batch
    key), or this rank's block of the batch as a plain tensor.

    Of a batch of B rows, rank r of R (:func:`batch_index`) holds global
    rows [r·B/R, (r+1)·B/R).  Microbatch m is the global rows [m·B/M,
    (m+1)·B/M), and rank r gets its r-th part of it, rows [m·B/M + r·b,
    m·B/M + (r+1)·b) with b = B/(M·R): the ranks' parts of a microbatch,
    in batch-index order, are that microbatch in the global order.  One
    all-to-all over the batch axes moves the blocks of b rows: local
    block i (global block j = r·M + i) goes to rank j mod R as its
    microbatch j div R.  Raises ``ValueError`` unless M·R divides B and
    this rank holds B/R of the rows."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor

    r, count = batch_index(mesh)
    rows = x.shape[0] if isinstance(x, DTensor) else x.shape[0] * count
    if isinstance(x, DTensor):
        x = x.to_local()
    n = x.shape[0]
    if rows % (microbatches * count) or n * count != rows:
        raise ValueError(
            f"a batch of B = {rows} rows does not split into "
            f"M = {microbatches} microbatches over R = {count} batch "
            f"ranks: B must be a multiple of M·R = {microbatches * count}")
    b = n // microbatches
    blocks = x.reshape(microbatches, b, *x.shape[1:])
    group = batch_group(mesh)
    if group is None:
        return list(blocks)
    dest = [(r * microbatches + i) % count for i in range(microbatches)]
    src = [(m * count + r) // microbatches for m in range(microbatches)]
    # sent in order of destination (then block), received in order of
    # source (then microbatch), which is microbatch order: the source of
    # microbatch m never decreases with m
    order = sorted(range(microbatches), key=lambda i: (dest[i], i))
    out = funcol.all_to_all_single(
        blocks[order].reshape(x.shape).contiguous(),
        [src.count(s) * b for s in range(count)],
        [dest.count(d) * b for d in range(count)], group)
    return list(funcol.wait_tensor(out).reshape(blocks.shape))


# ---------------------------------------------------------------------------
# Tensor-parallel regions over ``model``
# ---------------------------------------------------------------------------

class ModelShards(dict):
    """A layer's gathered parameters whose tensor-parallel dims hold this
    rank's shard over the mesh's ``model`` axis (built by
    :func:`repro_torch.launch.shardings.gather_params`): the layer takes
    its counts (heads, hidden width, vocabulary rows, experts) from the
    local weight shapes.  ``whole`` names the entries that hold no shard
    over ``model`` (the mixed GQA case's ``wk`` / ``wv``, the MoE
    router)."""

    def __init__(self, items=(), whole=()):
        super().__init__(items)
        self.whole = frozenset(whole)


def is_split(params) -> bool:
    """Is ``params`` a layer computed tensor-parallel over ``model``?"""
    return isinstance(params, ModelShards)


def model_size(mesh=None) -> int:
    """The size of the active (or given) mesh's ``model`` axis; 1 with no
    mesh or no such axis."""
    mesh = mesh if mesh is not None else _CTX.mesh
    return 1 if mesh is None else axis_sizes(mesh).get("model", 1)


def model_rank(mesh=None) -> int:
    """This rank's coordinate on the ``model`` axis (0 with no mesh)."""
    mesh = mesh if mesh is not None else _CTX.mesh
    if model_size(mesh) == 1:
        return 0
    return mesh.get_local_rank("model")


def model_group(mesh=None):
    """The process group of the ``model`` axis, or None where it holds
    one rank (every region operator is then the identity)."""
    mesh = mesh if mesh is not None else _CTX.mesh
    return None if model_size(mesh) == 1 else mesh.get_group("model")


def _all_reduce(x, group, op=None):
    import torch.distributed as dist

    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=group)
    return out


class _IntoModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _OutOfModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def into_model(x):
    """``x`` entering a tensor-parallel region: unchanged, its gradient
    summed over the ``model`` ranks (each computed the part of it that
    its shard of the layer reaches).  A sequence gathered by
    :func:`enter_seq` for split layers alone has entered already: its
    all-gather's backward sums the gradient."""
    group = model_group()
    if group is None or getattr(x, "_entered_model", False):
        return x
    return _IntoModel.apply(x, group)


def out_of_model(x):
    """A row-parallel partial sum leaving the region: the sum over the
    ``model`` ranks, the gradient passed through unchanged."""
    group = model_group()
    return x if group is None else _OutOfModel.apply(x, group)


def into_region(params, x):
    """``x`` through :func:`into_model` where ``params`` is a split layer,
    else unchanged."""
    return into_model(x) if is_split(params) else x


def model_all_reduce_max(x):
    """The elementwise maximum over the ``model`` ranks (no gradient)."""
    import torch.distributed as dist

    group = model_group()
    return x if group is None else _all_reduce(x, group, dist.ReduceOp.MAX)


def model_all_reduce(x):
    """The sum over the ``model`` ranks (no gradient)."""
    group = model_group()
    return x if group is None else _all_reduce(x, group)


def model_all_gather(x, dim: int = -1):
    """The ``model`` ranks' ``x`` concatenated along ``dim``, in rank
    order (no gradient)."""
    import torch.distributed as dist

    group = model_group()
    if group is None:
        return x
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(model_size())]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


# ---------------------------------------------------------------------------
# Sequence-parallel norm regions over ``model``
# ---------------------------------------------------------------------------

def seq_split(seq_len: int, mesh=None) -> bool:
    """Does a (rows, ``seq_len``, d) residual lie split over the sequence:
    does ``activation_spec`` shard its ("batch", "seq_sp", "embed")
    sequence dim over ``model``, of more than one rank?  Not where the
    sequence does not divide over ``model`` or is shorter than M (every
    decode step), where the reference replicates it; nor on an
    :class:`AbstractMesh`, which has no process group to gather over."""
    mesh = mesh if mesh is not None else _CTX.mesh
    if model_size(mesh) == 1 or isinstance(mesh, AbstractMesh):
        return False
    spec = activation_spec((1, seq_len, 1), ("batch", "seq_sp", "embed"),
                           mesh)
    return spec[1:2] == ("model",)


@contextlib.contextmanager
def seq_parallel(on: bool):
    """Run the residual stream split over the sequence (``on``) or whole,
    for this thread; the previous setting comes back on exit."""
    prev = _CTX.seq
    _CTX.seq = bool(on)
    try:
        yield
    finally:
        _CTX.seq = prev


def seq_parallel_on() -> bool:
    """Is the residual stream split over the sequence here?"""
    return _CTX.seq and model_group() is not None


def _seq_gather(x, group, size: int):
    """The ``model`` ranks' positions (dim 1) concatenated in rank order."""
    import torch.distributed as dist

    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def _seq_scatter(x, group, size: int):
    """The sum over the ``model`` ranks of ``x`` (b, s, ...), this rank's
    s/M positions of it."""
    import torch.distributed as dist

    chunks = [c.contiguous() for c in x.chunk(size, dim=1)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out


def _seq_own(x, rank: int, size: int):
    """This rank's s/M positions of ``x`` (b, s, ...), a copy."""
    n = x.shape[1] // size
    return x[:, rank * n:(rank + 1) * n].clone(
        memory_format=torch.contiguous_format)


class _EnterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank: int, size: int, summed: bool):
        ctx.args, ctx.summed = (group, rank, size), summed
        return _seq_gather(x, group, size)

    @staticmethod
    def backward(ctx, g):
        group, rank, size = ctx.args
        g = (_seq_scatter(g, group, size) if ctx.summed
             else _seq_own(g, rank, size))
        return g, None, None, None, None


class _ExitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size: int):
        ctx.args = (group, size)
        return _seq_scatter(x, group, size)

    @staticmethod
    def backward(ctx, g):
        return _seq_gather(g, *ctx.args), None, None


class _OwnSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank: int, size: int):
        ctx.args = (group, size)
        return _seq_own(x, rank, size)

    @staticmethod
    def backward(ctx, g):
        return _seq_gather(g, *ctx.args), None, None, None


def enter_seq(x, summed: bool):
    """The rank's positions ``x`` (b, s/M, ...) of a norm output entering
    the layers that read it: the whole sequence (b, s, ...), gathered over
    ``model`` (identity outside :func:`seq_parallel`).  The all-gather's
    backward must match what the gathered tensor feeds:

      * ``summed``: only split layers (or a query-split attention) read
        it, each rank's gradient a partial sum, so the backward is a
        reduce-scatter, and the layers' :func:`into_model` passes the
        tensor through (it has entered);
      * else some reader computes alike on every rank (a whole layer, the
        RWKV ddlerp, the MoE's routing, K / V projected whole) and every
        reader's gradient is whole and the same on every rank (the split
        ones, and an attention computing the rank's query rows, sum theirs
        in :func:`into_model`), so the backward is the rank's own
        positions of it, no sum: a sum would count it M times."""
    if not seq_parallel_on():
        return x
    out = _EnterSeq.apply(x, model_group(), model_rank(), model_size(),
                          summed)
    if summed:
        out._entered_model = True
    return out


def region_exit(y):
    """A split layer's partial output (b, s, ...) leaving its region: the
    sum over the ``model`` ranks, at the rank's s/M positions under
    :func:`seq_parallel` (a reduce-scatter forward, an all-gather
    backward), else whole (:func:`out_of_model`)."""
    if seq_parallel_on():
        return _ExitSeq.apply(y, model_group(), model_size())
    return out_of_model(y)


def at_positions(p):
    """A whole parameter applied at the rank's positions of a
    sequence-parallel stream (a norm's scale and bias, a bias added after
    :func:`region_exit`, the hybrid's branch scales): its gradient is the
    part of the rank's positions, summed over the ``model`` ranks
    (:func:`into_model`) so that it is whole and the same on every rank,
    as ``gather_params`` declares.  Unchanged where the stream is
    whole."""
    return into_model(p) if seq_parallel_on() else p


def own_positions(y, n: int):
    """A whole layer's output ``y`` (b, s, ...), computed alike on every
    rank, at the rank's ``n`` = s/M positions of the residual under
    :func:`seq_parallel` (a slice forward, an all-gather backward, so the
    layer's gradient is whole and the same on every rank); unchanged
    where it already has ``n`` positions or the stream is whole.  Its
    users: an MLP, a Mamba branch or an RWKV-6 mixer computed whole, the
    MoE's output, the channel-mix gate, the embedding behind image
    positions and the encoder's input projection.  Not an attention
    computed whole: it computes only the rank's query rows
    (:func:`repro_torch.core.attention.query_split`)."""
    if not seq_parallel_on() or y.shape[1] == n:
        return y
    return _OwnSeq.apply(y, model_group(), model_rank(), model_size())
