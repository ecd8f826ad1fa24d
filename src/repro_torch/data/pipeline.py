"""Deterministic LM batches: a pure function of (seed, step).

Port of :func:`repro.data.pipeline.lm_batch_at` (numpy; byte-identical
batches for the same config and step).  Restarting at step N replays the
exact stream with no iterator state to persist.  The reference's
background ``Prefetcher`` is not ported yet (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

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
