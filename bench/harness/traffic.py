"""The traffic generators, driven by a mix's data file and ``--seed``.

A mix file (``bench/traffic/<name>.json``) names its ``generator`` and
gives its parameters; nothing here knows a mix by name.

* ``lm_stream``: training batches of ``batch`` x ``seq_len`` tokens, the
  bigram-skewed LM token stream (each token follows 3x the previous plus
  a small jump, mod the vocabulary, 80% of the time; else uniform), one
  batch a step, every row its own draw from (seed, step).
* ``requests``: serving requests.  The sizes (prompt and output lengths,
  log-uniform over the mix's ranges) and the gaps between arrivals (an
  open loop's exponential gaps, a block of them scaled to ``rate``
  requests a second, or none
  for an offline queue) are one fixed sequence of ``block`` drawn from
  the mix's own ``base_seed``, repeated block after block; ``--seed``
  draws the token ids (uniform, no shared prefix, no end-of-sequence
  token).  So every seed serves the same work, and a run's numbers move
  with the system, not with the draw: at about 80 requests in a window,
  a seed that reordered the same sizes and gaps moved the chat cell's
  TTFT tail by half its value, where one seed run twice moved it by 2%.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator

import numpy as np

SEED_MOD = 2 ** 63


def _rng(*parts: int) -> np.random.Generator:
    return np.random.default_rng([int(p) % SEED_MOD for p in parts])


def lm_batch(mix: dict, vocab: int, seed: int, step: int):
    """(tokens, labels) int32 (batch, seq_len) of ``step``: the stream's
    next-token pairs."""
    b, s = mix["batch"], mix["seq_len"]
    rng = _rng(seed, step)
    cur = rng.integers(0, vocab, (b,))
    out = np.empty((b, s + 1), np.int64)
    out[:, 0] = cur
    for t in range(1, s + 1):
        jump = rng.integers(0, 7, (b,))
        stay = rng.random(b) < 0.8
        out[:, t] = np.where(stay, (3 * out[:, t - 1] + jump) % vocab,
                             rng.integers(0, vocab, (b,)))
    return out[:, :-1].astype(np.int32), out[:, 1:].astype(np.int32)


@dataclasses.dataclass
class Planned:
    """One request of the mix: its due time (seconds after the traffic's
    start), prompt and output length."""
    index: int
    due: float
    prompt: np.ndarray
    max_new: int


def _log_uniform(rng, lo: int, hi: int, n: int) -> np.ndarray:
    x = np.exp(rng.uniform(math.log(lo), math.log(hi + 1), n))
    return np.clip(np.floor(x).astype(np.int64), lo, hi)


def requests(mix: dict, vocab: int, seed: int) -> Iterator[Planned]:
    """The mix's requests under ``seed``, in order of their due times,
    without end."""
    block = mix["block"]
    base = _rng(mix["base_seed"])
    prompts = _log_uniform(base, *mix["prompt_len"], block)
    outputs = _log_uniform(base, *mix["output_len"], block)
    rate = mix.get("rate")
    gaps = np.zeros(block)
    if rate:
        # exponential gaps, scaled so that a block arrives at ``rate``
        gaps = base.exponential(1.0, block)
        gaps *= block / (rate * gaps.sum())
    rng = _rng(seed, 1)
    t, index = 0.0, 0
    while True:
        for j in range(block):
            t += gaps[j]
            yield Planned(index, t,
                          rng.integers(0, vocab, int(prompts[j])).astype(
                              np.int32), int(outputs[j]))
            index += 1
