"""Deterministic LM batches: a pure function of (seed, step).

Port of :mod:`repro.data.pipeline` (numpy; byte-identical batches for
the same config and step).  Restarting at step N replays the exact
stream with no iterator state to persist.  :class:`Prefetcher` keeps
``depth`` batches ahead of the training loop on a background thread (CPU
generation overlaps the device step).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    num_hosts: int = 1
    host_index: int = 0
    prefetch: int = 2


def _host_slice(cfg: PipelineConfig):
    per_host = cfg.global_batch // cfg.num_hosts
    lo = cfg.host_index * per_host
    return lo, lo + per_host


def lm_batch_at(cfg: PipelineConfig, step: int) -> Dict[str, np.ndarray]:
    """The (seed, step)-determined LM batch slice for this host."""
    from repro_torch.data.synthetic import lm_tokens

    lo, hi = _host_slice(cfg)
    seed = (cfg.seed * 1_000_003 + step) % (2 ** 31 - 1)
    tokens, labels = lm_tokens(hi - lo, cfg.seq_len, cfg.vocab_size,
                               seed * cfg.num_hosts + cfg.host_index)
    return {"tokens": tokens, "labels": labels}


class Prefetcher:
    """Background-thread prefetch over a (step -> batch) function; yields
    ``(step, batch)`` from ``start_step`` on, in order.  An exception in
    ``batch_fn`` ends the stream and is raised by the ``next`` that
    reaches it."""

    def __init__(self, batch_fn: Callable[[int], dict], start_step: int = 0,
                 depth: int = 2):
        self._fn = batch_fn
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step, item = self._step, None
        while not self._stop.is_set():
            if item is None:
                try:
                    item = (step, self._fn(step))
                except BaseException as e:  # raised by __next__
                    item = e
            try:
                self._q.put(item, timeout=0.5)
            except queue.Full:
                continue
            if isinstance(item, BaseException):
                return
            step, item = step + 1, None

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self):
        self._stop.set()
        # drain so the worker unblocks
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
