"""The paged inhibitor decode kernel's order of work (csrc/
paged_decode.cu, ``paged_inhibitor_split_kernel`` and its merge),
emulated in float32 torch on the CPU, against the JAX package's Pallas
kernel run in interpret mode (as tests/test_paged_kernels.py runs it)
and against the port's plain version.

The emulation follows the kernel: the table is cut into splits of
``pages_per_step`` pages; in each split that holds an attendable key,
per (kv head, dim) the sum of v over the split's keys, shared by the
group's query heads, and per (query head, dim) the sign-folded sum of
-sgn(v) min(|v|, z) (unsigned: -min(v, z)) with z = relu(sum_d |q - k| /
sqrt(d) - 0.5); the split's partial is their sum.  The merge computes
the splits overlapping [k_lo, k_hi) from ``lengths`` and the window
alone, adds their partials in split order and divides by the count
k_hi - k_lo.  The emulation reads only attendable positions: the pool's
trash page and every tail past a cursor hold nan, and the output must
stay finite.

Cases: signed and unsigned, normalize on and off, a window whose edge
lies inside a split, a length-0 row, two rows sharing pages, groups 1,
3 and 8, at ``pages_per_step`` 1, 2, 4 and 8 (8 to 1 splits of a table
of 8 pages).

Inputs are live: q and k of stddev 1/sqrt(d), so Z is about 0.6; each
check asserts that at least MIN_NONZERO_SHARE of the reference lies
above the tolerance, and that the emulation on V pages shifted by one
lies outside it.

Tolerances: float32, summation order only: rtol = atol = 1e-5
normalized; unnormalized, the JAX kernel's and the plain version's
eq. 9/10 forms cancel sums of up to n_k terms of size |V| + Z, so 1e-5
per key of the longest row (the stated tolerances of
tests/test_torch_paged.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged import paged_flash_inhibitor_fwd as jax_inhibitor
from repro_torch.kernels import paged as kpaged

TOL = dict(rtol=1e-5, atol=1e-5)
MIN_NONZERO_SHARE = 0.1
D, PS, KV_HEADS, WIDTH = 16, 4, 2, 8
# row 1 shares row 0's first three pages; row 2 has length 0; row 3's
# window edge (29 - 11 = 18) lies inside a split at every pages_per_step
LENGTHS = [32, 23, 0, 29, 1, 17]
SHARED_PAGES = 3


def _operands(seed, group):
    """q, k_pool, v_pool, tables, lengths (numpy) in the engine's layout,
    and the nan-poisoned pools: nan in the trash page, in every page no
    row maps, and past every cursor."""
    rng = np.random.default_rng(seed)
    batch, heads = len(LENGTHS), KV_HEADS * group
    num_pages = batch * WIDTH + 1
    std = D ** -0.5
    kp = (rng.normal(size=(num_pages, PS, KV_HEADS, D)) * std).astype(
        np.float32)
    vp = rng.normal(size=(num_pages, PS, KV_HEADS, D)).astype(np.float32)
    q = (rng.normal(size=(batch, 1, heads, D)) * std).astype(np.float32)
    perm = rng.permutation(np.arange(1, num_pages))
    tables = np.zeros((batch, WIDTH), np.int32)
    nxt = 0
    for row, ln in enumerate(LENGTHS):
        used = -(-ln // PS)
        tables[row, :used] = perm[nxt:nxt + used]
        nxt += used
    tables[1, :SHARED_PAGES] = tables[0, :SHARED_PAGES]
    lengths = np.asarray(LENGTHS, np.int32)
    kp_bad, vp_bad = kp.copy(), vp.copy()
    unused = np.setdiff1d(np.arange(num_pages), tables[tables > 0])
    kp_bad[unused], vp_bad[unused] = np.nan, np.nan
    for row, ln in enumerate(LENGTHS):
        if ln % PS:
            page = tables[row, ln // PS]
            kp_bad[page, ln % PS:], vp_bad[page, ln % PS:] = np.nan, np.nan
    return q, kp, vp, tables, lengths, kp_bad, vp_bad


def split_order(q, k_pool, v_pool, tables, lengths, *, pages_per_step,
                signed=True, normalize=True, window=None, score_shift=0.5):
    """The kernel's order of work in float32 torch (see the module
    docstring); returns (out (batch, 1, heads, d), splits read per row)."""
    batch, _, heads, d = q.shape
    _, ps, kv_heads, _ = k_pool.shape
    width = tables.shape[1]
    group = heads // kv_heads
    pps = max(1, min(pages_per_step, width))
    n_splits = kpaged.attention_splits(width, pps)
    span = pps * ps
    inv_scale = 1.0 / math.sqrt(d)
    out = torch.zeros(batch, 1, heads, d)
    splits_read = []
    for row in range(batch):
        ln = int(lengths[row])
        k_hi = min(ln, width * ps)
        k_lo = max(0, ln - window) if window is not None else 0
        # the merge's range, from lengths and the window alone
        merged = (range(k_lo // span, (k_hi - 1) // span + 1)
                  if k_lo < k_hi else range(0))
        splits_read.append(list(merged))
        for kvh in range(kv_heads):
            heads_of = slice(kvh * group, (kvh + 1) * group)
            qg = q[row, 0, heads_of]                           # (G, d)
            partials = {}
            for s in range(n_splits):
                s_lo, s_hi = max(k_lo, s * span), min(k_hi, (s + 1) * span)
                if s_lo >= s_hi:       # the block writes nothing
                    continue
                j = torch.arange(s_lo, s_hi)
                pages = tables[row, j // ps].long()
                k = k_pool[pages, j % ps, kvh]                 # (n, d)
                v = v_pool[pages, j % ps, kvh]
                z = torch.relu((qg[:, None] - k[None]).abs().sum(-1)
                               * inv_scale - score_shift)      # (G, n)
                sum_v = v.sum(0)                               # (d,), shared
                if signed:
                    a, ns = v.abs(), -torch.copysign(torch.ones_like(v), v)
                else:
                    a, ns = v, -torch.ones_like(v)
                acc = (ns[None] * torch.minimum(a[None], z[..., None])
                       ).sum(1)                                # (G, d)
                partials[s] = sum_v[None] + acc
            assert sorted(partials) == list(merged)
            t = torch.zeros(group, d)
            for s in merged:                                   # split order
                t = t + partials[s]
            if normalize:
                t = t / max(k_hi - k_lo, 1)
            out[row, 0, heads_of] = t
    return out, splits_read


# (kwargs, group)
CASES = {
    "signed": (dict(), 3),
    "unsigned": (dict(signed=False), 3),
    "unnormalized": (dict(normalize=False), 1),
    "unsigned_unnormalized": (dict(signed=False, normalize=False), 8),
    "window": (dict(window=11), 3),
    "unsigned_window_group8": (dict(signed=False, window=11), 8),
    "window_group1": (dict(window=11), 1),
}


@pytest.mark.parametrize("pages_per_step", [1, 2, 4, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_order_matches_jax_kernel_and_plain_version(case,
                                                          pages_per_step):
    kw, group = CASES[case]
    q, kp, vp, tables, lengths, kp_bad, vp_bad = _operands(
        17 + group, group)
    t = [torch.from_numpy(a) for a in (q, kp_bad, vp_bad, tables, lengths)]
    out, splits_read = split_order(*t, pages_per_step=pages_per_step, **kw)
    out = out.numpy()
    assert np.isfinite(out).all()
    assert not out[2].any()                    # the length-0 row
    assert splits_read[2] == []
    if "window" not in kw:                     # a full row reads them all
        n_splits = kpaged.attention_splits(WIDTH, pages_per_step)
        assert splits_read[0] == list(range(n_splits))
    ref = np.asarray(jax_inhibitor(
        *(jnp.asarray(a) for a in (q, kp, vp, tables, lengths)),
        pages_per_step=pages_per_step, interpret=True, **kw))
    plain = kpaged.paged_flash_inhibitor_plain(
        *(torch.from_numpy(a) for a in (q, kp, vp, tables, lengths)),
        **kw).numpy()
    control, _ = split_order(
        *(torch.from_numpy(a) for a in (q, kp, np.roll(vp, 1, axis=0),
                                        tables, lengths)),
        pages_per_step=pages_per_step, **kw)
    tol = (TOL if kw.get("normalize", True)
           else dict(rtol=1e-5, atol=1e-5 * max(LENGTHS)))
    for target in (ref, plain):
        np.testing.assert_allclose(out, target, **tol)
    bound = tol["atol"] + tol["rtol"] * np.abs(ref)
    share = float((np.abs(ref) > bound).mean())
    assert share >= MIN_NONZERO_SHARE, f"reference is ~0 ({share=})"
    assert bool((np.abs(control.numpy() - ref) > bound).any())
