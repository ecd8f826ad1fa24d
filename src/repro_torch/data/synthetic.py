"""Synthetic task generators (the paper's Table 1 benchmark suite, offline).

The port's own copy of :mod:`repro.data.synthetic` (numpy only): the same
(seed, shape) gives byte-identical arrays in both packages.

The paper evaluates on: the adding problem, MNIST, IMDB and IAM
handwriting.  No datasets ship with this container, so we reproduce each
task's *structure* with deterministic synthetic generators of matched
difficulty class:

  * ``adding``      — the exact Hochreiter & Schmidhuber task (two input
                      channels: uniform values + two-hot marker; target =
                      marked dot product). Identical to the paper's setup.
  * ``digits``      — MNIST surrogate: 10-class classification of 16×16
                      noisy class-template images, flattened to patch
                      sequences for a 1-layer transformer (paper's MNIST
                      protocol at reduced resolution).
  * ``sentiment``   — IMDB surrogate: binary classification of token
                      sequences where class-conditional token distributions
                      overlap (bag-of-words signal + noise), exercising the
                      same attention-pooling pathway.
  * ``copy_words``  — IAMW surrogate: sequence transduction with CTC-style
                      structure replaced by per-position classification of
                      blurred glyph sequences (edit-distance metric).
  * ``lm``          — deterministic token-stream generator for LM smoke
                      training (bigram-skewed sampling so loss decreases
                      measurably within a few hundred steps).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def adding_problem(batch: int, length: int, seed: int) -> Tuple[np.ndarray,
                                                                np.ndarray]:
    """Returns x: (b, length, 2), y: (b, 1)."""
    rng = np.random.default_rng(seed)
    vals = rng.uniform(0.0, 1.0, (batch, length)).astype(np.float32)
    marks = np.zeros((batch, length), np.float32)
    for i in range(batch):
        a, b = rng.choice(length, size=2, replace=False)
        marks[i, a] = 1.0
        marks[i, b] = 1.0
    y = np.sum(vals * marks, axis=1, keepdims=True).astype(np.float32)
    x = np.stack([vals, marks], axis=-1)
    return x, y


_DIGIT_CACHE = {}


def _digit_templates(res: int, seed: int = 1234) -> np.ndarray:
    key = (res, seed)
    if key not in _DIGIT_CACHE:
        rng = np.random.default_rng(seed)
        base = rng.normal(size=(10, res, res)).astype(np.float32)
        # smooth the templates so classes are locally structured
        for _ in range(2):
            base = (base + np.roll(base, 1, 1) + np.roll(base, -1, 1)
                    + np.roll(base, 1, 2) + np.roll(base, -1, 2)) / 5.0
        _DIGIT_CACHE[key] = base / np.abs(base).max()
    return _DIGIT_CACHE[key]


def digits(batch: int, seed: int, *, res: int = 16,
           noise: float = 0.7) -> Tuple[np.ndarray, np.ndarray]:
    """MNIST-surrogate: x (b, res, res), y (b,) in [0, 10)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, batch)
    temps = _digit_templates(res)
    x = temps[labels] + rng.normal(size=(batch, res, res)).astype(
        np.float32) * noise
    return x.astype(np.float32), labels.astype(np.int32)


def sentiment(batch: int, seed: int, *, length: int = 64,
              vocab: int = 512, signal: float = 0.25):
    """IMDB-surrogate: token ids (b, length), labels (b,) in {0,1}.

    Class c biases a disjoint 10%% slice of the vocabulary; ``signal`` is
    the fraction of positions drawn from the biased slice.
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, batch)
    slice_size = vocab // 10
    toks = rng.integers(0, vocab, (batch, length))
    n_sig = max(1, int(length * signal))
    for i in range(batch):
        pos = rng.choice(length, n_sig, replace=False)
        lo = labels[i] * slice_size
        toks[i, pos] = rng.integers(lo, lo + slice_size, n_sig)
    return toks.astype(np.int32), labels.astype(np.int32)


def copy_words(batch: int, seed: int, *, length: int = 12,
               n_glyphs: int = 26, glyph_dim: int = 16, noise: float = 0.5):
    """IAMW-surrogate: glyph embeddings (b, length, glyph_dim),
    target glyph ids (b, length)."""
    rng = np.random.default_rng(seed)
    protos = np.random.default_rng(999).normal(
        size=(n_glyphs, glyph_dim)).astype(np.float32)
    ids = rng.integers(0, n_glyphs, (batch, length))
    x = protos[ids] + rng.normal(size=(batch, length, glyph_dim)).astype(
        np.float32) * noise
    return x.astype(np.float32), ids.astype(np.int32)


def lm_tokens(batch: int, seq_len: int, vocab: int, seed: int):
    """Bigram-skewed token stream: tokens (b, s+1) -> (inputs, labels)."""
    rng = np.random.default_rng(seed)
    # deterministic bigram preference: next ~ 3*cur + small noise (mod V)
    cur = rng.integers(0, vocab, (batch,))
    out = np.empty((batch, seq_len + 1), np.int64)
    out[:, 0] = cur
    for t in range(1, seq_len + 1):
        jump = rng.integers(0, 7, (batch,))
        stay = rng.random(batch) < 0.8
        nxt = np.where(stay, (3 * out[:, t - 1] + jump) % vocab,
                       rng.integers(0, vocab, (batch,)))
        out[:, t] = nxt
    return out[:, :-1].astype(np.int32), out[:, 1:].astype(np.int32)
