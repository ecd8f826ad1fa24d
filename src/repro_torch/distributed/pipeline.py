"""Pipeline parallelism: the GPipe microbatch schedule over a ``pipe``
mesh axis, on point-to-point sends.

Port of :mod:`repro.distributed.pipeline`.  The production mesh defaults
to (pod, data, model); PP is an optional axis for deployments whose
interconnect favours it, and :func:`make_pp_mesh` builds (pipe, data,
model).

Schedule: the classic GPipe loop with M microbatches over S stages runs
S + M − 1 ticks; each tick every stage applies its slice to its resident
microbatch and sends the activation to the next stage (cyclically, as
the reference's ``ppermute`` does; with one stage the send goes to the
rank itself).  Stage 0 injects microbatch t at tick t; the last stage
emits microbatch t − (S − 1).  The bubble fraction is (S − 1)/(S + M − 1)
(:func:`bubble_fraction`).  The outputs of the other stages are zeroed
and summed over ``pipe``, so every rank returns the whole result.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import _ring_shift
from repro_torch.tree import tree_map


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    return (num_stages - 1) / (num_stages + num_microbatches - 1)


def make_pp_mesh(num_stages: int, data: int = 1, model: int = 1, *,
                 device_type=None):
    """A ("pipe", "data", "model") mesh over the current process group."""
    from repro_torch.launch.mesh import _mesh

    return _mesh((num_stages, data, model), ("pipe", "data", "model"),
                 device_type)


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, mesh,
                   *, num_microbatches: int) -> torch.Tensor:
    """Run the GPipe schedule; returns the outputs, microbatch leading.

    ``stage_fn(params, x) -> y`` keeps x's shape.  ``stage_params``: this
    rank's stage slice with its leading stage axis of 1 (a local shard of
    the stacked parameters, or a DTensor sharded on ``pipe``).  ``x``:
    (num_microbatches, mb, ...), the same on every rank."""
    from torch.distributed.tensor import DTensor

    group = mesh.get_group("pipe")
    num_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    ticks = num_stages + num_microbatches - 1
    params = tree_map(
        lambda p: (p.to_local() if isinstance(p, DTensor) else p)[0],
        stage_params)

    state = torch.zeros_like(x[0])              # resident activation
    outputs = torch.zeros_like(x)
    for t in range(ticks):
        cur = x[t] if stage == 0 and t < num_microbatches else state
        y = stage_fn(params, cur)
        if stage == num_stages - 1 and t >= num_stages - 1:
            outputs[t - (num_stages - 1)] = y
        state = _ring_shift(y, group)           # stage s -> s + 1
    if stage != num_stages - 1:
        outputs = torch.zeros_like(outputs)
    dist.all_reduce(outputs, group=group)
    return outputs
