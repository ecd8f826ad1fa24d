"""Async checkpoint manager: overlap saves with training, retention,
auto-resume.

Port of :mod:`repro.checkpoint.manager`.  The train loop calls
``maybe_save(step, tree)`` every step; the manager decides cadence,
snapshots the tree to host memory (blocking only for the device->host
copy), and runs the file write on a background thread so the next step
launches immediately.  ``wait()`` drains in-flight writes (called before
exit and before a restore) and re-raises a failed write.

The snapshot is a copy, on the CPU too: the port's optimizer updates
parameters and moments in place, and ``.cpu()`` of a host tensor returns
the same storage, so a snapshot that shared it would be written while
the next step overwrites it.

Under a mesh (``mesh=``, whose ranks must be the whole process group)
every rank calls the same methods in the same order.  A save gathers
each DTensor leaf whole (``full_tensor``, a collective), one leaf at a
time and in leaf order, on the main thread; rank 0 keeps a host copy of
each, so the card's peak grows by one leaf, and rank 0 alone writes the
commit (on the writer thread) and runs ``retain``.  ``wait`` ends with
rank 0's word that its write is committed, so no rank goes on before
it; ``latest_step`` is rank 0's answer, and a restore reads that step on
every rank.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.tree import tree_map


@dataclasses.dataclass
class CheckpointConfig:
    root: str
    every_steps: int = 100
    keep: int = 3
    async_save: bool = True


def _snapshot(leaf):
    """A host copy of one leaf that no later in-place update can reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, np.ndarray):
        return leaf.copy()
    return leaf


class CheckpointManager:
    def __init__(self, cfg: CheckpointConfig, *, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._writer = True
        if mesh is not None:
            import torch.distributed as dist

            if mesh.size() != dist.get_world_size():
                raise ValueError(
                    f"a checkpoint mesh of {mesh.size()} ranks in a "
                    f"process group of {dist.get_world_size()}: the mesh "
                    "must hold every rank")
            self._writer_rank = int(mesh.mesh.flatten()[0])
            self._writer = dist.get_rank() == self._writer_rank

    def _from_writer(self, value: int) -> int:
        """Rank 0's ``value`` on every rank of the mesh (a broadcast, so
        no rank returns before rank 0 has sent it)."""
        import torch.distributed as dist

        from repro_torch.launch.shardings import mesh_device

        t = torch.tensor([value], dtype=torch.int64,
                         device=mesh_device(self.mesh))
        dist.broadcast(t, src=self._writer_rank)
        return int(t.item())

    @torch.no_grad()
    def _host_copy(self, leaf):
        """Rank 0's snapshot of one leaf, gathered whole if it is a
        DTensor (every rank takes part); None on the other ranks."""
        from torch.distributed.tensor import DTensor

        if isinstance(leaf, DTensor):
            leaf = leaf.detach().full_tensor()
        return _snapshot(leaf) if self._writer else None

    # ---- save path ----
    def _write(self, step: int, host_tree, extra):
        try:
            store.save(self.cfg.root, step, host_tree, extra=extra)
            store.retain(self.cfg.root, self.cfg.keep)
        except BaseException as e:  # surfaced on next wait()
            self._error = e

    def save(self, step: int, tree: Any, *, extra: Optional[dict] = None):
        self.wait()
        host_tree = tree_map(self._host_copy, tree)
        if self._writer and self.cfg.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host_tree, extra),
                daemon=True)
            self._thread.start()
        elif self._writer:
            self._write(step, host_tree, extra)
        if not self.cfg.async_save:
            self.wait()

    def maybe_save(self, step: int, tree: Any, *,
                   extra: Optional[dict] = None) -> bool:
        if step % self.cfg.every_steps:
            return False
        self.save(step, tree, extra=extra)
        return True

    def wait(self):
        """Drain the in-flight write and re-raise its failure; under a
        mesh every rank returns only once rank 0's write is committed,
        and raises if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if (self.mesh is not None and self._from_writer(err is not None)
                and err is None):
            raise RuntimeError("rank 0's checkpoint write failed")
        if err is not None:
            raise err

    # ---- restore path ----
    def latest_step(self) -> Optional[int]:
        if self.mesh is None:
            return store.latest_step(self.cfg.root)
        step = store.latest_step(self.cfg.root) if self._writer else None
        step = self._from_writer(-1 if step is None else step)
        return None if step < 0 else step

    def restore(self, tree_like: Any, *, device=None, shardings=None):
        """(tree, step) of the newest commit, leaves on ``device`` (default:
        the card) or, with ``shardings``, this rank's shards as DTensors
        (:func:`repro_torch.checkpoint.store.restore`)."""
        self.wait()
        return store.restore(self.cfg.root, tree_like,
                             step=self.latest_step(), device=device,
                             shardings=shardings)

    def restore_or_init(self, init_fn: Callable[[], Any], *, device=None,
                        shardings=None):
        """Auto-resume: restore the latest committed checkpoint if one
        exists, else initialize fresh.  Returns (tree, start_step).  The
        port has no abstract evaluation, so the structure to restore into
        is ``init_fn()``'s own."""
        tree = init_fn()
        if self.latest_step() is None:
            return tree, 0
        return self.restore(tree, device=device, shardings=shardings)
