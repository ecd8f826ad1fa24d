"""Nested parameter containers: the port's counterpart of ``jax.tree``.

Parameters, gradients and optimizer moments are nested dicts and lists
of tensors.  Leaves are visited in ``jax.tree`` order (dict keys sorted,
list items in order), so a flat list of leaves lines up with the
reference's.
"""

from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over matching leaves of ``tree`` and ``rest`` (same
    structure), visited in :func:`tree_leaves` order; returns a tree of
    ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like: Any, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
