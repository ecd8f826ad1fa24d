"""Sharded npz checkpoint store: atomic, crash-consistent, resumable.

Port of :mod:`repro.checkpoint.store`, with the same layout (one
checkpoint = one directory):

    <root>/step_00000100/
        meta.json            # step, leaf inventory, extra
        shard_00000.npz      # flattened leaves, chunked by byte budget
        ...
        COMMITTED            # written LAST -> presence = checkpoint valid

Crash consistency: writers stage into ``step_N.tmp`` and rename after the
COMMITTED marker is in place; readers ignore directories without the
marker, so a host failure mid-save can never corrupt the restore point
(the previous checkpoint remains the newest committed one).

Trees are the port's containers (:mod:`repro_torch.tree`): nested dicts,
lists and tuples — ``AdamWState`` with its int32 ``step`` included — of
tensors, numpy arrays or scalars.  Leaves are named as the reference
names them: dict keys, sequence indices and ``.field`` for a NamedTuple
(``0/blocks/3/attn/wq/kernel``, ``1/.step``).  ``None`` is an empty
subtree, as in ``jax.tree``, so ``restore(root, (params, None))`` reads
the parameters of a ``(params, opt_state)`` checkpoint alone.  numpy has
no bfloat16: such a leaf is written as the reference's store writes one
(its two bytes as a ``|V2`` array, ``"bfloat16"`` in the inventory) and
restored bit for bit.  So a tree of the same structure gives the
reference's inventory, and each package restores the other's commit
(bfloat16 leaves apart: the reference's own ``restore`` refuses the
``|V2`` array it wrote, which the port reads).
The model parameters differ in structure (the reference stacks the
layers under ``blocks``, the port lists them), so a model commit crosses
over through :func:`repro_torch.convert.params_from_jax`.

A commit always holds full tensors.  Under a mesh the manager
(:mod:`repro_torch.checkpoint.manager`) gathers each DTensor leaf whole
and rank 0 alone writes, so a commit made under a mesh is a one-process
commit, layout, inventory and names included.  :func:`restore` puts
every leaf on one device, or, given ``shardings`` (the reference's
argument), keeps on each rank its own shard of each leaf as a DTensor
(:func:`repro_torch.launch.shardings.place`): every rank reads the
commit.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_flatten_with_path, tree_map_with_path

_MARKER = "COMMITTED"
_SHARD_BYTES = 512 * 1024 * 1024
_BF16 = "bfloat16"
_RAW16 = np.dtype("V2")        # how numpy stores an ml_dtypes bfloat16


def _name(path) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(leaf):
    """(array, dtype name) of one leaf; bfloat16 as its raw two bytes."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_RAW16), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(root: str, step: int, tree: Any, *, extra: Optional[dict] = None):
    """Write a committed checkpoint for ``tree`` at ``step``."""
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest = []
    shard, shard_bytes, shard_idx = {}, 0, 0

    def flush():
        nonlocal shard, shard_bytes, shard_idx
        if shard:
            np.savez(os.path.join(tmp, f"shard_{shard_idx:05d}.npz"), **shard)
            shard, shard_bytes = {}, 0
            shard_idx += 1

    for i, (path, leaf) in enumerate(tree_flatten_with_path(tree)):
        arr, dtype = _to_numpy(leaf)
        key = f"leaf_{i:06d}"
        manifest.append({"name": _name(path), "key": key,
                         "shard": shard_idx, "dtype": dtype,
                         "shape": list(arr.shape)})
        shard[key] = arr
        shard_bytes += arr.nbytes
        if shard_bytes >= _SHARD_BYTES:
            flush()
    flush()

    meta = {"step": step, "leaves": manifest, "extra": extra or {}}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(tmp, _MARKER), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def committed_steps(root: str) -> list:
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(root, name, _MARKER)):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    continue
    return sorted(steps)


def latest_step(root: str) -> Optional[int]:
    steps = committed_steps(root)
    return steps[-1] if steps else None


def restore(root: str, tree_like: Any, *, step: Optional[int] = None,
            device=None, shardings: Any = None):
    """Restore into the structure of ``tree_like``; returns (tree, step).

    Every leaf becomes a tensor on ``device`` (default: the card) with
    the dtype it was saved with; a leaf of ``tree_like`` that has a
    ``shape`` must match the saved shape.  ``step`` defaults to the
    newest committed checkpoint.  ``shardings``: a tree of
    :class:`~repro_torch.distributed.sharding.NamedSharding` matching
    ``tree_like`` (as :func:`repro_torch.launch.shardings.params_shardings`
    / ``opt_shardings`` give it); each leaf then becomes a DTensor of its
    sharding holding this rank's shard, on the mesh's device, and
    ``device`` is not used.
    """
    dev = resolve_device(device) if shardings is None else None
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {root}")
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)

    wanted = {_name(p) for p, _ in tree_flatten_with_path(tree_like)}
    missing = sorted(wanted - {e["name"] for e in meta["leaves"]})
    if missing:
        raise KeyError(f"checkpoint missing leaves: {missing[:5]}...")
    by_shard = {}
    for entry in meta["leaves"]:
        if entry["name"] in wanted:
            by_shard.setdefault(entry["shard"], []).append(entry)
    values = {}
    for shard_idx, entries in by_shard.items():
        with np.load(os.path.join(d, f"shard_{shard_idx:05d}.npz")) as z:
            for e in entries:
                arr = z[e["key"]]
                if e["dtype"] == _BF16:
                    t = torch.from_numpy(arr.view(np.int16)).view(
                        torch.bfloat16)
                else:
                    t = torch.from_numpy(arr)
                values[e["name"]] = t

    def place(path, like):
        t = values[_name(path)]
        shape = getattr(like, "shape", None)
        if shape is not None and tuple(shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf {_name(path)!r} has shape "
                             f"{tuple(t.shape)}, expected {tuple(shape)}")
        return t if dev is None else t.to(dev)

    tree = tree_map_with_path(place, tree_like)
    if shardings is not None:
        from repro_torch.launch import shardings as shlib

        tree = shlib.place(tree, shardings)
    return tree, step


def retain(root: str, keep: int):
    """Delete all but the newest ``keep`` committed checkpoints."""
    steps = committed_steps(root)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(root, f"step_{s:08d}"), ignore_errors=True)
