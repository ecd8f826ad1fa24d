"""Weights drawn from ``--seed`` on the device, in the program's parameter
layout (the configuration's family gives it), in a few large calls.

Every float32 weight of the model lies in one flat buffer filled with unit
normals by a ``torch.Generator`` on the device, in slices of at most 2^30
elements; each leaf is a view of it, scaled in place: a projection by
1/sqrt(its fan-in), the embedding table and a head by their stated
standard deviations, a norm's scale set to 1 and a bias to 0; a family
fills a leaf of an init of its own (a constant, a range) itself.  The query
and key projections are scaled by a further factor, the configuration's
``attention.query_key_init_scale``: "1/sqrt(head_dim)" under the
inhibitor, so that the shifted score Z is about 0.6 and the inhibition is
not vacuous (at unit q and k every output would be 0), or a number.
The same seed gives the same tensors, so the reference draws them again
instead of reading anything the program has held.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from harness import families

SLICE = 1 << 30


def layout(model: dict) -> List[Tuple[tuple, tuple, str]]:
    """[(path, shape, init)] of the configuration's parameters in the
    program's tree, as its family lays them out: ``init`` is
    "fan_in:<n>", "std:<s>", "ones" or "zeros"."""
    return families.of(model).layout(model)


def fill(model: dict, leaf: torch.Tensor, init: str) -> None:
    """Fill ``leaf`` in place by an ``init`` of the family's own (a
    constant decay, Mamba's log [1..n]): its module's ``fill``."""
    fam = families.of(model)
    if not hasattr(fam, "fill"):
        raise ValueError(f"family {families.name(model)!r} names the init "
                         f"{init!r} and gives no fill(leaf, init)")
    fam.fill(leaf, init)


def _set(tree: dict, path: tuple, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            continue
        if isinstance(nxt, int):
            blocks = node.setdefault(key, [])
            while len(blocks) <= nxt:
                blocks.append({})
            node = blocks[nxt]
        else:
            node = node.setdefault(key, {})
    node[path[-1]] = value


def query_key_scale(model: dict) -> float:
    """The further factor of ``wq`` and ``wk`` the configuration states."""
    scale = model["attention"]["query_key_init_scale"]
    if scale == "1/sqrt(head_dim)":
        return model["head_dim"] ** -0.5
    return float(scale)


def draw(model: dict, seed: int, device) -> dict:
    """The parameter tree of ``model`` drawn from ``seed`` on ``device``:
    float32 views of one flat buffer."""
    entries = layout(model)
    total = sum(math.prod(shape) for _p, shape, _i in entries)
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.empty(total, dtype=torch.float32, device=device)
    for lo in range(0, total, SLICE):
        buf[lo:lo + SLICE].normal_(generator=gen)
    tree: dict = {}
    off = 0
    with torch.no_grad():
        for path, shape, init in entries:
            n = math.prod(shape)
            leaf = buf[off:off + n].view(shape)
            off += n
            if init == "ones":
                leaf.fill_(1.0)
            elif init == "zeros":
                leaf.zero_()
            elif init.partition(":")[0] in ("fan_in", "std"):
                kind, val = init.split(":")
                std = float(val) ** -0.5 if kind == "fan_in" else float(val)
                if path[-2] in ("wq", "wk"):
                    std *= query_key_scale(model)
                leaf.mul_(std)
            else:
                fill(model, leaf, init)
            _set(tree, path, leaf)
    return tree


def leaves(tree) -> list:
    """The tensors of a tree in the program's order (dict insertion, list
    index)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def paths(tree, prefix: tuple = ()) -> list:
    """The paths of :func:`leaves`, in the same order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in paths(v, prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in paths(v, prefix + (i,))]
    return [prefix]
