"""Nested parameter containers: the port's counterpart of ``jax.tree``.

Parameters, gradients and optimizer moments are nested dicts, lists and
tuples (NamedTuples such as ``AdamWState`` included) of tensors.  Leaves
are visited in ``jax.tree`` order (dict keys sorted, sequence items in
order), so a flat list of leaves lines up with the reference's.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


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
        return _rebuild(tree, [tree_map(fn, t, *(r[i] for r in rest))
                               for i, t in enumerate(tree)])
    return fn(tree, *rest)


def _rebuild(seq, items: list):
    """A sequence of ``seq``'s type holding ``items`` (a NamedTuple takes
    them as positional fields)."""
    if hasattr(seq, "_fields"):
        return type(seq)(*items)
    return type(seq)(items)


def _keys(seq) -> list:
    """A sequence's path keys: its indices, or a NamedTuple's ``.field``s."""
    if hasattr(seq, "_fields"):
        return ["." + f for f in seq._fields]
    return list(range(len(seq)))


def tree_flatten_with_path(tree: Any, prefix: Tuple = ()) -> List[tuple]:
    """``[(path, leaf), ...]`` in :func:`tree_leaves` order; a path is the
    tuple of dict keys, sequence indices and NamedTuple fields (``.name``,
    as ``str`` of a ``jax.tree_util.GetAttrKey`` reads) from the root.
    ``None`` is an empty subtree (no leaf), as in ``jax.tree``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_flatten_with_path(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for name, t in zip(_keys(tree), tree)
                for x in tree_flatten_with_path(t, prefix + (name,))]
    return [(prefix, tree)]


def tree_map_with_path(fn: Callable, tree: Any, prefix: Tuple = ()) -> Any:
    """``fn(path, leaf)`` over the leaves of ``tree`` (paths as in
    :func:`tree_flatten_with_path`); ``None`` subtrees stay ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], prefix + (k,))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [tree_map_with_path(fn, t, prefix + (name,))
                               for name, t in zip(_keys(tree), tree)])
    return fn(prefix, tree)


def tree_unflatten(like: Any, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
