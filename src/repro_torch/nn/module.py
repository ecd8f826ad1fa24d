"""Parameters annotated with logical sharding axes, and tree helpers.

Port of :mod:`repro.nn.module`.  The port's models return plain nested
dicts (lists for the per-layer stacks) of tensors, and each family
builds the matching tree of **logical axis names** with a function
written beside its init (``ModelApi.axes()``), one tuple per tensor,
e.g. ``("vocab", "embed")``.  :class:`Param` pairs a tensor with its
axes; the rules tables of :mod:`repro_torch.distributed.sharding` map
the names onto mesh axes.

Usage pattern::

    params = api.init(gen)                   # tree of tensors
    axes   = api.axes()                      # same structure, tuple leaves
    boxed  = box_like(params, axes)          # tree of Param
    params = unbox(boxed); axes = axes_of(boxed)

A :class:`Param` is a leaf of :mod:`repro_torch.tree` (not a container),
so ``tree_map`` over a boxed tree visits whole boxes.  An axes tuple is a
tuple, which the tree helpers descend into: map over an axes tree by
driving ``tree_map`` with the tensor tree (``tree_map(fn, params,
axes)`` hands ``fn`` each tensor beside its whole tuple).

Keys: the reference folds string names into JAX PRNG keys.  Here a
"key" is a ``torch.Generator``; :func:`fold_key` derives a new generator
from a generator's initial seed and the crc32 of a name, which is
process-invariant (Python's ``hash()`` is salted per process by
``PYTHONHASHSEED``).  No model init draws through them: the port's inits
draw in sequence from one generator; they are ported for the API.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable

import torch

from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map

PyTree = Any


@dataclasses.dataclass
class Param:
    """A tensor annotated with logical sharding axes: one entry per dim,
    ``None`` = replicated / no constraint on that dim."""

    value: Any
    axes: tuple

    def __post_init__(self):
        self.axes = tuple(self.axes)
        if hasattr(self.value, "ndim") and len(self.axes) != self.value.ndim:
            raise ValueError(
                f"Param axes {self.axes} rank mismatch with value shape "
                f"{tuple(getattr(self.value, 'shape', '?'))}")

    @property
    def shape(self):
        return self.value.shape

    @property
    def dtype(self):
        return self.value.dtype


def is_param(x) -> bool:
    return isinstance(x, Param)


def unbox(tree: PyTree) -> PyTree:
    """Strip Param boxes, returning a plain-tensor tree of the same
    structure (a leaf that is not a Param stays as it is)."""
    return tree_map(lambda p: p.value if is_param(p) else p, tree)


def axes_of(tree: PyTree) -> PyTree:
    """The logical-axes tree matching ``unbox(tree)``'s structure."""
    return tree_map(lambda p: p.axes, tree)


def box_like(arrs: PyTree, axes: PyTree) -> PyTree:
    """Re-attach axis annotations to a plain-tensor tree."""
    return tree_map(Param, arrs, axes)


def _plain(tree: PyTree) -> list:
    return [p.value if is_param(p) else p for p in tree_leaves(tree)]


def param_count(tree: PyTree) -> int:
    """Elements over every tensor of a boxed or plain tree."""
    return sum(int(x.numel()) for x in _plain(tree))


def param_bytes(tree: PyTree) -> int:
    return sum(int(x.numel()) * x.element_size() for x in _plain(tree))


_MASK63 = (1 << 63) - 1


def _derive(seed: int, salt: int) -> int:
    """A 63-bit seed from (seed, salt): splitmix64's finaliser."""
    z = (seed + 0x9E3779B97F4A7C15 * (salt + 1)) & ((1 << 64) - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) & _MASK63


def _generator(like: torch.Generator, seed: int) -> torch.Generator:
    return torch.Generator(device=like.device).manual_seed(seed)


def split_keys(key: torch.Generator, n: int) -> list:
    """``n`` generators derived from ``key``'s initial seed (``key``'s
    own state is not consumed, as ``jax.random.split`` is pure)."""
    return [_generator(key, _derive(key.initial_seed(), i))
            for i in range(n)]


def fold_key(key: torch.Generator, name: str) -> torch.Generator:
    """Deterministically derive a generator from a string name, through
    the crc32 of the name (stable across processes), as the reference
    folds ``zlib.crc32(name) % (2**31 - 1)`` into its key."""
    h = zlib.crc32(name.encode("utf-8")) % (2**31 - 1)
    return _generator(key, _derive(key.initial_seed(), h))


class KeyGen:
    """Convenience splitter: ``kg = KeyGen(gen); g1 = kg('wq')``."""

    def __init__(self, key: torch.Generator):
        self._key = key

    def __call__(self, name: str) -> torch.Generator:
        return fold_key(self._key, name)


def format_tree(tree: PyTree, max_leaves: int = 200) -> str:
    """Human-readable parameter inventory (shape / dtype / axes per leaf),
    paths in the port's per-layer layout (``blocks/0/attn/wq/kernel``)."""
    lines = []
    flat = tree_flatten_with_path(tree)
    for path, leaf in flat[:max_leaves]:
        name = "/".join(str(p) for p in path)
        if is_param(leaf):
            lines.append(
                f"  {name:60s} {str(tuple(leaf.value.shape)):24s} "
                f"{str(leaf.value.dtype):10s} axes={leaf.axes}")
        else:
            lines.append(f"  {name:60s} {leaf!r}")
    if len(flat) > max_leaves:
        lines.append(f"  ... (+{len(flat) - max_leaves} more)")
    return "\n".join(lines)


def tree_map_params(fn: Callable, tree: PyTree) -> PyTree:
    """Map ``fn`` over the tensors of a tree, keeping Param annotations."""
    return tree_map(
        lambda p: Param(fn(p.value), p.axes) if is_param(p) else fn(p), tree)


def cast_params(tree: PyTree, dtype) -> PyTree:
    """Cast every floating-point tensor to ``dtype`` (integer tensors
    untouched)."""
    return tree_map_params(
        lambda x: x.to(dtype) if x.is_floating_point() else x, tree)
