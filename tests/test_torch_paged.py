"""The port's paged decode kernels (repro_torch.kernels.paged) against the
JAX package's Pallas kernels run in interpret mode, on the sweep of
tests/test_paged_kernels.py: signed/unsigned, window None/5, normalize,
ragged and page-straddling cursors, shared pages, a length-0 row and a
poisoned trash page.  On the CPU the wrappers run their plain versions
(gather + fused form); the CUDA kernels themselves are held against the
same plain versions on the card (tests/test_torch_kernels_cuda.py and
chip_smoke.py).

Tolerance: both sides compute in float32 and differ only in summation
order (the JAX kernel sums page by page, the plain version over the whole
gathered row), so rtol = atol = 1e-5.  Without normalization the eq. 9/10
forms of both sides cancel sums of up to n_k terms of size |V| + Z, so
the absolute tolerance there is 1e-5 per key of the longest row.

Inputs are live.  For the inhibitor, q and k have stddev 1/sqrt(d): the
score Z = sum_d |q - k| / sqrt(d) - 0.5 is then about 0.6, so relu(v -
Z) and min(v + Z, 0) are nonzero for a quarter to a half of unit-normal
v (at unit q and k, Z is about 4 at d = 16 and almost every output is
0).  Each inhibitor check also asserts that at least MIN_NONZERO_SHARE
of the reference lies above the tolerance, and that the port on V pages
shifted by one (a kernel reading the wrong pages) lies outside it.

A length-0 row outputs 0 under both mechanisms, as the reference kernels
do; the reference's dot-product gather oracle would instead average the
masked values, which is why the port's plain version is held against the
kernel and not the oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged import (paged_flash_attention_fwd as jax_attention,
                                 paged_flash_inhibitor_fwd as jax_inhibitor)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import paged as kpaged

# full float32 matmuls and convolutions on a card (TF32 keeps ~3 digits)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-5, atol=1e-5)
RAGGED_LENGTHS = [13, 8, 1, 24]     # page 8: straddle, exact, single, full
INH_STD = 16 ** -0.5                # inhibitor q and k at d = 16
# least share of reference elements above the tolerance in every
# inhibitor case (most of the reference lies above it on these inputs;
# at unit q and k almost none does)
MIN_NONZERO_SHARE = 0.1


def _pool(rng, *, batch, pages_per_slot, page_size, kv_heads, d, lengths,
          qk_std=1.0):
    """Ragged pool in the engine's layout (numpy): non-contiguous pages,
    trash page 0 behind every unmapped table entry; k of stddev
    ``qk_std``, v unit normal."""
    num_pages = batch * pages_per_slot + 1
    kp = (rng.normal(size=(num_pages, page_size, kv_heads, d))
          * qk_std).astype(np.float32)
    vp = rng.normal(size=(num_pages, page_size, kv_heads, d)).astype(
        np.float32)
    perm = rng.permutation(np.arange(1, num_pages))
    tables = np.zeros((batch, pages_per_slot), np.int32)
    nxt = 0
    for b, ln in enumerate(lengths):
        used = -(-int(ln) // page_size)
        tables[b, :used] = perm[nxt:nxt + used]
        nxt += used
    return kp, vp, tables, np.asarray(lengths, np.int32)


def _both(q, kp, vp, tables, lengths, *, attention=False, **kw):
    """(JAX interpret-mode kernel, port wrapper on CPU tensors)."""
    j = (jax_attention if attention else jax_inhibitor)(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lengths), interpret=True, **kw)
    t = (kpaged.paged_flash_attention_fwd if attention
         else kpaged.paged_flash_inhibitor_fwd)(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(lengths), **kw)
    return np.asarray(j), t.numpy()


def _port(q, kp, vp, tables, lengths, *, attention=False, **kw):
    """The port's wrapper alone, on CPU tensors from numpy."""
    fwd = (kpaged.paged_flash_attention_fwd if attention
           else kpaged.paged_flash_inhibitor_fwd)
    return fwd(*(torch.from_numpy(np.ascontiguousarray(a))
                 for a in (q, kp, vp, tables, lengths)), **kw).numpy()


def assert_live_match(out, ref, control, *, rtol, atol):
    """out within tolerance of ref; at least MIN_NONZERO_SHARE of ref
    above the tolerance; ``control`` (computed on wrong V pages) outside
    it."""
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol)
    tol = atol + rtol * np.abs(ref)
    share = float((np.abs(ref) > tol).mean())
    assert share >= MIN_NONZERO_SHARE, f"reference is ~0 ({share=})"
    assert bool((np.abs(control - ref) > tol).any()), (
        "wrong-page control within tolerance")


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("normalize", [True, False])
def test_paged_inhibitor_matches_jax_kernel(rng, signed, window, normalize):
    kp, vp, tables, lengths = _pool(
        rng, batch=4, pages_per_slot=4, page_size=8, kv_heads=2, d=16,
        lengths=RAGGED_LENGTHS, qk_std=INH_STD)
    q = (rng.normal(size=(4, 1, 4, 16)) * INH_STD).astype(np.float32)
    kw = dict(signed=signed, window=window, normalize=normalize)
    ref, out = _both(q, kp, vp, tables, lengths, **kw)
    control = _port(q, kp, np.roll(vp, 1, axis=0), tables, lengths, **kw)
    tol = TOL if normalize else dict(rtol=1e-5,
                                     atol=1e-5 * max(RAGGED_LENGTHS))
    assert_live_match(out, ref, control, **tol)


@pytest.mark.parametrize("window", [None, 5])
def test_paged_attention_matches_jax_kernel(rng, window):
    kp, vp, tables, lengths = _pool(
        rng, batch=4, pages_per_slot=4, page_size=8, kv_heads=2, d=16,
        lengths=RAGGED_LENGTHS)
    q = rng.normal(size=(4, 1, 4, 16)).astype(np.float32)
    ref, out = _both(q, kp, vp, tables, lengths, attention=True,
                     window=window)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("attention", [False, True])
def test_shared_pages_zero_length_and_poisoned_trash(rng, attention):
    """Rows 0/1 share two physical pages, row 3 has length 0 (output 0),
    and the trash page plus every tail past a cursor hold ±1e9: the port
    on the poisoned pool equals the JAX kernel on the clean one, and the
    port on V pages shifted by one does not (inhibitor q and k at stddev
    1/sqrt(d), as above)."""
    heads, kv_heads, d, ps = 4, 2, 16, 8
    std = 1.0 if attention else INH_STD
    kp = (rng.normal(size=(13, ps, kv_heads, d)) * std).astype(np.float32)
    vp = rng.normal(size=(13, ps, kv_heads, d)).astype(np.float32)
    lengths = np.asarray([21, 18, 13, 0], np.int32)
    tables = np.zeros((4, 4), np.int32)
    tables[0, :3] = [1, 2, 3]
    tables[1, :3] = [1, 2, 4]
    tables[2, :2] = [5, 6]
    q = (rng.normal(size=(4, 1, heads, d)) * std).astype(np.float32)
    kp_bad, vp_bad = kp.copy(), vp.copy()
    unused = np.setdiff1d(np.arange(13), tables[tables > 0])
    kp_bad[unused], vp_bad[unused] = 1e9, -1e9
    for b, ln in enumerate(lengths):
        if ln % ps:
            page = tables[b, ln // ps]
            kp_bad[page, ln % ps:], vp_bad[page, ln % ps:] = 1e9, -1e9
    ref, _ = _both(q, kp, vp, tables, lengths, attention=attention)
    _, out = _both(q, kp_bad, vp_bad, tables, lengths, attention=attention)
    control = _port(q, kp, np.roll(vp, 1, axis=0), tables, lengths,
                    attention=attention)
    assert_live_match(out, ref, control, **TOL)
    assert not out[3].any()


def test_cpu_wrappers_run_the_plain_version_and_count(rng):
    kp, vp, tables, lengths = _pool(
        rng, batch=2, pages_per_slot=2, page_size=8, kv_heads=2, d=16,
        lengths=[5, 9])
    args = [torch.from_numpy(a) for a in (kp, vp, tables, lengths)]
    q = torch.from_numpy(rng.normal(size=(2, 1, 4, 16)).astype(np.float32))
    kpaged.reset_counts()
    kops.paged_flash_inhibitor(q, *args)
    kops.paged_flash_attention(q, *args)
    assert kpaged.counts() == {
        "paged_inhibitor": 0, "paged_attention": 0,
        "paged_inhibitor_plain": 1, "paged_attention_plain": 1}
    with pytest.raises(ValueError, match="single-query"):
        kpaged.paged_flash_inhibitor_fwd(q.expand(2, 3, 4, 16), *args)


def test_registry_default_override_and_native_platforms(rng):
    assert kops.NATIVE_PLATFORMS == {
        "inhibitor": ("cuda",), "flash": ("cuda",), "paged": ("cuda",),
        "wkv6": ("cuda",)}
    r = kops.KernelRegistry()
    key = ("inhibitor", 4, 8, 4, 2, 16)
    assert r.choose("paged", key, "cpu") == kops.CANDIDATES["paged"][0]
    assert r.decisions[("paged",) + key]["source"] == "default-cpu"
    assert r.decisions[("paged",) + key]["native"] is False
    got = r.choose("paged", key, "cuda", kops.KernelChoice(pages_per_step=2))
    assert got.pages_per_step == 2
    d = r.decisions[("paged",) + key]
    assert d["source"] == "override" and d["native"] is True


# (heads, kv_heads, head_dim, do the split kernels take it): group 9,
# group 5 (llama4-scout, hymba-1.5b), group 7 (qwen2-0.5b), group 8, a
# head_dim the kernels were not built for
SPLIT_SHAPES = [(9, 1, 64, False), (25, 5, 64, True), (14, 2, 64, True),
                (8, 1, 128, True), (8, 2, 80, False)]


@pytest.mark.parametrize("heads,kv_heads,d,takes", SPLIT_SHAPES)
def test_planner_plans_the_split_softmax_only_where_it_runs(
        heads, kv_heads, d, takes):
    """On a ``cuda`` platform (set through AttnShapes: no card needed),
    ``paged_pallas`` is eligible for each mechanism exactly where its
    split kernel takes the shape (kernels.paged's own refusal, per
    kernel), and the planner sends the rest to the gather without
    raising."""
    from repro_torch.core import mechanism as tmech
    from repro_torch.core.attention import AttentionConfig

    shapes = tmech.AttnShapes(batch=8, n_q=1, n_k=512, num_heads=heads,
                              num_kv_heads=kv_heads, head_dim=d,
                              has_cache=True, scalar_cursor=False,
                              platform="cuda", paged=True)
    cfg = AttentionConfig(mechanism="dotprod", num_heads=heads,
                          num_kv_heads=kv_heads, head_dim=d)
    ok, why = tmech.backend_eligible("paged_pallas", cfg, shapes,
                                     tmech.get_mechanism("dotprod"))
    assert ok == takes
    assert ok or "paged attention kernel: group" in why
    assert (kpaged.split_refusal("flash", heads // kv_heads, d)
            is None) == takes
    assert tmech.plan_attention(cfg, shapes).backend == (
        "paged_pallas" if takes else "paged")
    inh = AttentionConfig(mechanism="inhibitor", num_heads=heads,
                          num_kv_heads=kv_heads, head_dim=d)
    ok, why = tmech.backend_eligible("paged_pallas", inh, shapes,
                                     tmech.get_mechanism("inhibitor"))
    assert ok == takes
    assert ok or "paged inhibitor kernel: group" in why
    assert (kpaged.split_refusal("inhibitor", heads // kv_heads, d)
            is None) == takes
    assert tmech.plan_attention(inh, shapes).backend == (
        "paged_pallas" if takes else "paged")
