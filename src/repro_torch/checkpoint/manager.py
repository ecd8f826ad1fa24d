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
    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ---- save path ----
    def _write(self, step: int, host_tree, extra):
        try:
            store.save(self.cfg.root, step, host_tree, extra=extra)
            store.retain(self.cfg.root, self.cfg.keep)
        except BaseException as e:  # surfaced on next wait()
            self._error = e

    def save(self, step: int, tree: Any, *, extra: Optional[dict] = None):
        self.wait()
        host_tree = tree_map(_snapshot, tree)
        if self.cfg.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host_tree, extra),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host_tree, extra)
            self.wait()

    def maybe_save(self, step: int, tree: Any, *,
                   extra: Optional[dict] = None) -> bool:
        if step % self.cfg.every_steps:
            return False
        self.save(step, tree, extra=extra)
        return True

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ---- restore path ----
    def latest_step(self) -> Optional[int]:
        return store.latest_step(self.cfg.root)

    def restore(self, tree_like: Any, *, device=None):
        """(tree, step) of the newest commit, leaves on ``device`` (default:
        the card)."""
        self.wait()
        return store.restore(self.cfg.root, tree_like, device=device)

    def restore_or_init(self, init_fn: Callable[[], Any], *, device=None):
        """Auto-resume: restore the latest committed checkpoint if one
        exists, else initialize fresh.  Returns (tree, start_step).  The
        port has no abstract evaluation, so the structure to restore into
        is ``init_fn()``'s own."""
        tree = init_fn()
        if self.latest_step() is None:
            return tree, 0
        return self.restore(tree, device=device)
