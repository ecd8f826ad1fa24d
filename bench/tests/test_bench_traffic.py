"""The traffic generators are deterministic per seed, and every seed
serves the same sizes and arrival gaps in another order."""

from __future__ import annotations

import itertools

import bench_tiny  # noqa: F401
import numpy as np
import pytest

from harness import cell as cells
from harness import traffic


def _take(mix, seed, n=128):
    return list(itertools.islice(traffic.requests(mix, 1000, seed), n))


def test_lm_batches_repeat_per_seed_and_step():
    mix = {"batch": 4, "seq_len": 32}
    a = traffic.lm_batch(mix, 500, 7, 3)
    b = traffic.lm_batch(mix, 500, 7, 3)
    c = traffic.lm_batch(mix, 500, 7, 4)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    tokens, labels = a
    assert tokens.shape == labels.shape == (4, 32)
    assert np.array_equal(tokens[:, 1:], labels[:, :-1])
    assert len({r.tobytes() for r in tokens}) == 4      # rows all differ


def test_large_seed_is_accepted():
    mix = {"batch": 2, "seq_len": 8}
    traffic.lm_batch(mix, 100, 2 ** 31 + 12345, 0)
    mix = cells.load("smollm-inh.chat").mix
    assert len(_take(mix, 3_000_000_007, 4)) == 4


def test_every_seed_serves_the_same_work():
    mix = cells.load("smollm-inh.chat").mix
    a, b, c = _take(mix, 11), _take(mix, 11), _take(mix, 12)
    assert [(r.due, r.max_new, r.prompt.tobytes()) for r in a] == \
        [(r.due, r.max_new, r.prompt.tobytes()) for r in b]
    assert [(r.due, len(r.prompt), r.max_new) for r in a] == \
        [(r.due, len(r.prompt), r.max_new) for r in c]
    assert a[0].prompt.tobytes() != c[0].prompt.tobytes()
    block = mix["block"]
    assert [len(r.prompt) for r in a[:block]] == \
        [len(r.prompt) for r in a[block:2 * block]]
    lo, hi = mix["prompt_len"]
    assert all(lo <= len(r.prompt) <= hi for r in a)
    dues = [r.due for r in a]
    assert dues == sorted(dues)
    # a block arrives at ``rate`` requests a second
    assert a[block - 1].due == pytest.approx(block / mix["rate"])


def test_offline_queue_has_no_gaps():
    mix = cells.load("llava7b-inh.batch").mix
    assert all(r.due == 0.0 for r in _take(mix, 5, 70))
