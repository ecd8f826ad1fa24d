"""The CUDA kernels (csrc/paged_decode.cu, csrc/flash_prefill.cu,
csrc/wkv6.cu) against their plain versions, on the card; the redesigned
kernels (the bf16 Softmax flash forward on the tensor cores, the paged
Softmax and inhibitor decode split over pages, the register-tiled flash
inhibitor) also at their tiles' and splits' edges, every group the split
kernels take beyond smollm's 3 that a config needs (5, 7) and their
largest (8), the inhibitor also at head_dim 16 and 128.  Every
test here needs a CUDA card and skips without one; the file imports no
JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: float32 — rtol = atol = 1e-5 (summation order only); bf16 —
the kernel and the plain version round the same float32 value, so two
ulps (2^-7) of the output's largest magnitude for the paged kernels, and
one ulp of each element (2^-7 relative, plus 1e-5) for the prefill
kernels, whose normalized outputs average up to 1000 keys and so lie far
below their largest magnitude.  Unnormalized inhibitor
sums are not swept: their plain version cancels n_k-term sums (see
chip_smoke.py for that case).

Inputs are drawn so that no check passes on zeros.  For the inhibitor, q
and k have stddev 1/sqrt(d): the score Z = sum_d |q - k| / sqrt(d) - 0.5
is then about 0.6 at every head_dim, so relu(v - Z) and min(v + Z, 0) are
nonzero for a quarter to a half of unit-normal values.  At unit q and k,
Z would be about 8.5 at d = 64 and every output exactly 0.  Each check
also asserts that a share of the reference lies above the tolerance, and
that the reference computed on V pages shifted by one (for the prefill
kernels: V rolled by one key) disagrees.
"""

import pytest
import torch

from repro_torch.kernels import flash as kflash
from repro_torch.kernels import inhibitor as kinh
from repro_torch.kernels import ops as kops
from repro_torch.kernels import paged as kpaged
from repro_torch.kernels import rwkv6 as krwkv6

# full float32 matmuls and convolutions on a card (TF32 keeps ~3 digits)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ULP = {torch.float32: None, torch.bfloat16: 2.0 ** -7}
# least share of reference elements above the tolerance: window 1,
# unsigned gives about 0.2 (one key per row, relu(v - Z) > 0 for a
# quarter of values, one row of eight has length 0)
MIN_NONZERO_SHARE = 0.1


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


def _case(seed, *, batch, heads, kv_heads, d, ps, width, lengths, dtype,
          qk_std=1.0, share=True, poison=float("nan")):
    """Pool, tables and lengths on the card; q and k have stddev
    ``qk_std``, v is unit normal.  Unmapped entries and every tail past a
    cursor hold ``poison`` (never read by the kernels)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    pages = batch * width + 1
    kp = (torch.randn((pages, ps, kv_heads, d), generator=g, device="cuda")
          * qk_std).to(dtype)
    vp = torch.randn((pages, ps, kv_heads, d), generator=g,
                     device="cuda").to(dtype)
    perm = (torch.randperm(pages - 1, generator=g, device="cuda")
            + 1).tolist()
    tables = torch.zeros((batch, width), dtype=torch.int32)
    nxt = 0
    for row, ln in enumerate(lengths):
        used = -(-ln // ps)
        tables[row, :used] = torch.tensor(perm[nxt:nxt + used],
                                          dtype=torch.int32)
        nxt += used
    if share and batch > 1 and lengths[0] >= ps and lengths[1] >= ps:
        tables[1, 0] = tables[0, 0]       # rows 0/1 share their first page
    q = (torch.randn((batch, 1, heads, d), generator=g, device="cuda")
         * qk_std).to(dtype)
    clean = (kp.clone(), vp.clone())
    kp[0], vp[0] = poison, poison
    for row, ln in enumerate(lengths):
        if ln % ps:
            page = int(tables[row, ln // ps])
            kp[page, ln % ps:], vp[page, ln % ps:] = poison, poison
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, clean, tables.cuda(), lens


def _err_tol(out, ref, dtype, elementwise=False):
    if ULP[dtype] is None:
        tol = 1e-5 + 1e-5 * ref.float().abs()
    elif elementwise:
        tol = 1e-5 + ULP[dtype] * ref.float().abs()
    else:
        tol = 2 * ULP[dtype] * max(1.0, ref.float().abs().max().item())
    return (out.float() - ref.float()).abs(), tol


def _check(out, ref, dtype, control, elementwise=False):
    """out within tolerance of ref; ref materially nonzero; ``control``
    (the reference on wrong V pages) outside it."""
    assert torch.isfinite(out).all()
    err, tol = _err_tol(out, ref, dtype, elementwise)
    assert bool((err <= tol).all()), f"max_abs_err {err.max().item()}"
    share = (ref.float().abs() > tol).float().mean().item()
    assert share >= MIN_NONZERO_SHARE, f"reference is ~0 ({share=})"
    bad, _ = _err_tol(control, ref, dtype, elementwise)
    assert not bool((bad <= tol).all()), "control within tolerance"


SHAPES = [  # (heads, kv_heads, d, page_size)
    (9, 3, 64, 16),      # smollm-135m
    (4, 4, 32, 8),       # paper-tiny widths, no GQA
    (8, 2, 128, 32),     # wide heads, big pages
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pages_per_step", [1, 4, 8])
def test_kernels_match_plain_versions(shape, dtype, pages_per_step):
    _needs_card()
    heads, kv_heads, d, ps = shape
    width = 8
    lengths = [ps * width, ps + 1, 1, 0, ps - 1, 3 * ps, 2 * ps + 5, ps]
    kw = dict(batch=len(lengths), heads=heads, kv_heads=kv_heads, d=d,
              ps=ps, width=width, lengths=lengths, dtype=dtype)
    inh = _case(0, qk_std=d ** -0.5, **kw)
    att = _case(1, **kw)
    for window in (None, 1, 5, 2 * ps + 3):
        q, kp, vp, (kc, vc), tables, lens = inh
        for signed in (True, False):
            out = kpaged.paged_flash_inhibitor_fwd(
                q, kp, vp, tables, lens, signed=signed, window=window,
                pages_per_step=pages_per_step)
            ref, control = (kpaged.paged_flash_inhibitor_plain(
                q, kc, v, tables, lens, signed=signed, window=window)
                for v in (vc, vc.roll(1, dims=0)))
            _check(out, ref, dtype, control)
        q, kp, vp, (kc, vc), tables, lens = att
        out = kpaged.paged_flash_attention_fwd(
            q, kp, vp, tables, lens, window=window,
            pages_per_step=pages_per_step)
        ref, control = (kpaged.paged_flash_attention_plain(
            q, kc, v, tables, lens, window=window)
            for v in (vc, vc.roll(1, dims=0)))
        _check(out, ref, dtype, control)
        assert not out[3].any()            # the length-0 row


@pytest.mark.cuda
def test_pages_per_step_does_not_change_a_bit():
    """The pages per split (both kernels) are a launch knob: float32
    results are identical up to summation order, and the nan poison is
    never read."""
    _needs_card()
    for fwd, qk_std in ((kpaged.paged_flash_inhibitor_fwd, 0.125),
                        (kpaged.paged_flash_attention_fwd, 1.0)):
        q, kp, vp, _, tables, lens = _case(
            1, batch=4, heads=9, kv_heads=3, d=64, ps=16, width=32,
            lengths=[512, 300, 17, 1], dtype=torch.float32, qk_std=qk_std)
        outs = [fwd(q, kp, vp, tables, lens, pages_per_step=pps)
                for pps in (1, 2, 4, 8)]
        assert (outs[0].abs() > 1e-3).float().mean().item() >= 0.5
        for o in outs[1:]:
            torch.testing.assert_close(o, outs[0], rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pages_per_step", [1, 2, 4, 8])
def test_paged_attention_splits_at_their_edges(dtype, pages_per_step):
    """The Softmax split over pages: lengths at each of the first split
    boundaries and one either side, a 512-token row beside 1-token rows,
    two rows sharing pages across a split boundary, and windows that
    start inside a split; nan in the trash page and past every cursor."""
    _needs_card()
    ps, width = 16, 32
    span = ps * pages_per_step                 # keys per split
    shared = 2 * span + 5                      # row 8 shares row 7's pages
    lengths = [1, span - 1, span, span + 1, 2 * span - 1, 2 * span,
               2 * span + 1, 512, shared, 1]
    q, kp, vp, (kc, vc), tables, lens = _case(
        9, batch=len(lengths), heads=9, kv_heads=3, d=64, ps=ps,
        width=width, lengths=lengths, dtype=dtype)
    used = -(-shared // ps)
    tables[8, :used] = tables[7, :used]
    for window in (None, 5, span + 3):
        out = kpaged.paged_flash_attention_fwd(
            q, kp, vp, tables, lens, window=window,
            pages_per_step=pages_per_step)
        assert torch.equal(out, kpaged.paged_flash_attention_fwd(
            q, kc, vc, tables, lens, window=window,
            pages_per_step=pages_per_step))
        ref, control = (kpaged.paged_flash_attention_plain(
            q, kc, v, tables, lens, window=window)
            for v in (vc, vc.roll(1, dims=0)))
        _check(out, ref, dtype, control)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [5, 7, 8])
def test_paged_attention_split_at_large_groups(dtype, group):
    """The split Softmax at 5 (llama4-scout, hymba-1.5b), 7 (qwen2-0.5b)
    and 8 query heads per kv head: ragged lengths across split edges,
    shared pages, windows, nan past every cursor."""
    _needs_card()
    lengths = [1, 63, 64, 65, 200, 512, 129, 0]
    q, kp, vp, (kc, vc), tables, lens = _case(
        12 + group, batch=len(lengths), heads=2 * group, kv_heads=2, d=64,
        ps=16, width=32, lengths=lengths, dtype=dtype)
    for window in (None, 5, 70):
        out = kpaged.paged_flash_attention_fwd(q, kp, vp, tables, lens,
                                               window=window)
        assert torch.equal(out, kpaged.paged_flash_attention_fwd(
            q, kc, vc, tables, lens, window=window))
        ref, control = (kpaged.paged_flash_attention_plain(
            q, kc, v, tables, lens, window=window)
            for v in (vc, vc.roll(1, dims=0)))
        _check(out, ref, dtype, control)
        assert not out[7].any()                # the length-0 row


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pages_per_step", [1, 2, 4, 8])
def test_paged_inhibitor_splits_at_their_edges(dtype, pages_per_step):
    """The inhibitor split over pages, signed and unsigned: lengths at
    each of the first split boundaries and one either side, a 512-token
    row beside 1-token rows, two rows sharing pages across a split
    boundary, windows that start inside a split; nan in the trash page
    and past every cursor changes no bit."""
    _needs_card()
    ps, width, d = 16, 32, 64
    span = ps * pages_per_step                 # keys per split
    shared = 2 * span + 5                      # row 8 shares row 7's pages
    lengths = [1, span - 1, span, span + 1, 2 * span - 1, 2 * span,
               2 * span + 1, 512, shared, 1]
    q, kp, vp, (kc, vc), tables, lens = _case(
        19, batch=len(lengths), heads=9, kv_heads=3, d=d, ps=ps,
        width=width, lengths=lengths, dtype=dtype, qk_std=d ** -0.5)
    used = -(-shared // ps)
    tables[8, :used] = tables[7, :used]
    for window in (None, 5, span + 3):
        for signed in (True, False):
            kw = dict(window=window, signed=signed,
                      pages_per_step=pages_per_step)
            out = kpaged.paged_flash_inhibitor_fwd(q, kp, vp, tables, lens,
                                                   **kw)
            assert torch.equal(out, kpaged.paged_flash_inhibitor_fwd(
                q, kc, vc, tables, lens, **kw))
            ref, control = (kpaged.paged_flash_inhibitor_plain(
                q, kc, v, tables, lens, window=window, signed=signed)
                for v in (vc, vc.roll(1, dims=0)))
            _check(out, ref, dtype, control)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [5, 7, 8])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_paged_inhibitor_split_at_large_groups(dtype, group, d):
    """The split inhibitor at 5, 7 and 8 query heads per kv head and
    head_dim 16, 64 and 128 (1 to 32 lanes a key): ragged lengths across
    split edges, shared pages, windows, signed and unsigned, nan past
    every cursor; the length-0 row writes 0."""
    _needs_card()
    lengths = [1, 63, 64, 65, 200, 512, 129, 0]
    q, kp, vp, (kc, vc), tables, lens = _case(
        20 + group, batch=len(lengths), heads=2 * group, kv_heads=2, d=d,
        ps=16, width=32, lengths=lengths, dtype=dtype, qk_std=d ** -0.5)
    for window in (None, 5, 70):
        for signed in (True, False):
            kw = dict(window=window, signed=signed)
            out = kpaged.paged_flash_inhibitor_fwd(q, kp, vp, tables, lens,
                                                   **kw)
            assert torch.equal(out, kpaged.paged_flash_inhibitor_fwd(
                q, kc, vc, tables, lens, **kw))
            ref, control = (kpaged.paged_flash_inhibitor_plain(
                q, kc, v, tables, lens, **kw)
                for v in (vc, vc.roll(1, dims=0)))
            _check(out, ref, dtype, control)
            assert not out[7].any()            # the length-0 row


@pytest.mark.cuda
def test_wrapper_counts_launches_and_rejects_bad_operands():
    _needs_card()
    q, kp, vp, _, tables, lens = _case(
        2, batch=2, heads=4, kv_heads=2, d=16, ps=8, width=2,
        lengths=[9, 4], dtype=torch.float32)
    kpaged.reset_counts()
    kpaged.paged_flash_inhibitor_fwd(q, kp, vp, tables, lens)
    kpaged.paged_flash_attention_fwd(q, kp, vp, tables, lens)
    assert kpaged.counts() == {
        "paged_inhibitor": 1, "paged_attention": 1,
        "paged_inhibitor_plain": 0, "paged_attention_plain": 0}
    with pytest.raises(TypeError, match="int32"):
        kpaged.paged_flash_inhibitor_fwd(q, kp, vp, tables.long(), lens)
    with pytest.raises(TypeError, match="share"):
        kpaged.paged_flash_inhibitor_fwd(q.half(), kp, vp, tables, lens)
    with pytest.raises(ValueError, match="contiguous"):
        kpaged.paged_flash_inhibitor_fwd(q, kp, vp, tables.t().contiguous()
                                         .t(), lens)
    with pytest.raises(ValueError, match="one CUDA device"):
        kpaged.paged_flash_inhibitor_fwd(q, kp, vp, tables.cpu(), lens)
    assert kpaged.counts()["paged_inhibitor"] == 1


# ---------------------------------------------------------------------------
# blockwise prefill kernels (flash inhibitor, flash attention)
# ---------------------------------------------------------------------------

PREFILL_SHAPES = [  # (heads, kv_heads, d)
    (9, 3, 64),          # smollm-135m
    (4, 4, 32),          # paper-tiny widths, no GQA
    (8, 2, 128),         # wide heads
    (4, 2, 16),          # reduced test widths
]


def _prefill_operands(seed, *, batch, n, heads, kv_heads, d, dtype,
                      qk_std):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda")
                * std).to(dtype)

    return (mk(batch, n, heads, d, std=qk_std),
            mk(batch, n, kv_heads, d, std=qk_std), mk(batch, n, kv_heads, d))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PREFILL_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1000, 64])
def test_prefill_kernels_match_plain_versions(shape, dtype, n):
    """Causal, windowed and non-causal cases at a ragged n (1000: neither
    tile divides it) and a short one, signed and unsigned, with shift."""
    _needs_card()
    heads, kv_heads, d = shape
    kw = dict(batch=2, n=n, heads=heads, kv_heads=kv_heads, d=d, dtype=dtype)
    inh = _prefill_operands(0, qk_std=d ** -0.5, **kw)
    att = _prefill_operands(1, qk_std=1.0, **kw)
    for causal, window in ((True, None), (True, 64), (False, None)):
        q, k, v = inh
        for signed in (True, False):
            m = dict(causal=causal, window=window, signed=signed)
            out = kinh.flash_inhibitor_fwd(q, k, v, **m)
            ref, control = (kinh.flash_inhibitor_plain(q, k, vv, **m)
                            for vv in (v, v.roll(1, dims=1)))
            _check(out, ref, dtype, control, elementwise=True)
        q, k, v = att
        m = dict(causal=causal, window=window)
        out = kflash.flash_attention_fwd(q, k, v, **m)
        ref, control = (kflash.flash_attention_plain(q, k, vv, **m)
                        for vv in (v, v.roll(1, dims=1)))
        _check(out, ref, dtype, control, elementwise=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_cursors_never_read_past_the_cursor(dtype):
    """Ragged per-row q_offset / kv_valid_len; every key past a row's
    cursor holds nan, and a row with kv_valid_len 0 outputs 0."""
    _needs_card()
    b, n_q, n_k, heads, kv_heads, d = 4, 37, 300, 9, 3, 64
    offs = torch.tensor([0, 100, 250, 5], dtype=torch.int32, device="cuda")
    valid = torch.tensor([37, 137, 300, 0], dtype=torch.int32,
                         device="cuda")
    for name, std in (("inhibitor", d ** -0.5), ("attention", 1.0)):
        q, _, _ = _prefill_operands(2, batch=b, n=n_q, heads=heads,
                                    kv_heads=kv_heads, d=d, dtype=dtype,
                                    qk_std=std)
        _, k, v = _prefill_operands(3, batch=b, n=n_k, heads=heads,
                                    kv_heads=kv_heads, d=d, dtype=dtype,
                                    qk_std=std)
        kn, vn = k.clone(), v.clone()
        for row, ln in enumerate(valid.tolist()):
            kn[row, ln:], vn[row, ln:] = float("nan"), float("nan")
        for window in (None, 16):
            if name == "inhibitor":
                fwd, plain = kinh.flash_inhibitor_fwd, kinh.flash_inhibitor_plain
            else:
                fwd, plain = (kflash.flash_attention_fwd,
                              kflash.flash_attention_plain)
            cur = dict(q_offset=offs, kv_valid_len=valid, window=window)
            out = fwd(q, kn, vn, **cur)
            assert torch.equal(out, fwd(q, k, v, **cur))
            ref, control = (plain(q, k, vv, **cur)
                            for vv in (v, v.roll(1, dims=1)))
            _check(out, ref, dtype, control, elementwise=True)
            assert not out[3].any()            # the kv_valid_len 0 row


def _late(v):
    """V one key late (at one key: the other batch row's V), the control
    of the prefill checks."""
    return v.roll(1, dims=1 if v.shape[1] > 1 else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("block_q", kflash.BLOCK_QS)
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("n", [1, 65, 1000])
def test_flash_tensor_core_tiles_match_plain_version(block_q, d, n):
    """The bf16 tensor-core kernel at every query tile of the registry,
    every head_dim, one query, one past a 64-key tile and a ragged 1000:
    causal, window 1 (each query its own key), window 64, non-causal."""
    _needs_card()
    q, k, v = _prefill_operands(7, batch=2, n=n, heads=6, kv_heads=2, d=d,
                                dtype=torch.bfloat16, qk_std=1.0)
    for causal, window in ((True, None), (True, 1), (True, 64),
                           (False, None)):
        m = dict(causal=causal, window=window)
        out = kflash.flash_attention_fwd(q, k, v, block_q=block_q, **m)
        ref, control = (kflash.flash_attention_plain(q, k, vv, **m)
                        for vv in (v, _late(v)))
        _check(out, ref, torch.bfloat16, control, elementwise=True)


@pytest.mark.cuda
@pytest.mark.parametrize("block_q", kflash.BLOCK_QS)
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_tensor_core_never_reads_past_the_cursor(block_q, d):
    """n_q != n_k with ragged per-row cursors: a diagonal row, an offset
    row ending at n_k, a kv_valid_len 0 row, a row whose cursor cuts
    inside a key tile, a row whose cursor lies below all its queries;
    every key past a cursor holds nan, which must enter shared memory as
    zeros and change no bit."""
    _needs_card()
    b, n_q, n_k = 5, 65, 200
    offs = torch.tensor([0, 135, 64, 3, 190], dtype=torch.int32,
                        device="cuda")
    valid = torch.tensor([65, 200, 0, 70, 129], dtype=torch.int32,
                         device="cuda")
    q, _, _ = _prefill_operands(8, batch=b, n=n_q, heads=6, kv_heads=2, d=d,
                                dtype=torch.bfloat16, qk_std=1.0)
    _, k, v = _prefill_operands(9, batch=b, n=n_k, heads=6, kv_heads=2, d=d,
                                dtype=torch.bfloat16, qk_std=1.0)
    kn, vn = k.clone(), v.clone()
    for row, ln in enumerate(valid.tolist()):
        kn[row, ln:], vn[row, ln:] = float("nan"), float("nan")
    for window in (None, 1, 50):
        cur = dict(q_offset=offs, kv_valid_len=valid, window=window)
        out = kflash.flash_attention_fwd(q, kn, vn, block_q=block_q, **cur)
        assert torch.equal(out, kflash.flash_attention_fwd(
            q, k, v, block_q=block_q, **cur))
        ref, control = (kflash.flash_attention_plain(q, k, vv, **cur)
                        for vv in (v, _late(v)))
        _check(out, ref, torch.bfloat16, control, elementwise=True)
        assert not out[2].any()                # the kv_valid_len 0 row


@pytest.mark.cuda
def test_redesigned_kernels_reject_what_they_do_not_take():
    """A bf16 query tile the tensor-core kernel does not take raises (the
    float32 variant halves any tile to fit); operands that are not 16-byte
    aligned raise for all four 16-byte-copy kernels; the split Softmax and
    the split inhibitor take at most kpaged._SPLIT_MAX_GROUP = 8 query
    heads per kv head."""
    _needs_card()
    q, k, v = _prefill_operands(10, batch=1, n=40, heads=4, kv_heads=2, d=16,
                                dtype=torch.bfloat16, qk_std=1.0)
    kops.reset_counts()
    for bad in (16, 32, 256):
        with pytest.raises(ValueError, match="query tiles"):
            kflash.flash_attention_fwd(q, k, v, block_q=bad)
    kflash.flash_attention_fwd(q.float(), k.float(), v.float(), block_q=16)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")
    shifted = flat[1:].view(q.shape).copy_(q)
    with pytest.raises(ValueError, match="aligned"):
        kflash.flash_attention_fwd(shifted, k, v)
    with pytest.raises(ValueError, match="aligned"):
        kinh.flash_inhibitor_fwd(shifted, k, v)
    assert kops.counts()["flash_attention"] == 1
    assert kops.counts()["flash_inhibitor"] == 0
    assert kpaged._SPLIT_MAX_GROUP == 8
    qp, kp, vp, _, tables, lens = _case(
        11, batch=2, heads=9, kv_heads=1, d=16, ps=8, width=2,
        lengths=[9, 4], dtype=torch.float32)
    with pytest.raises(ValueError, match="paged attention kernel: group"):
        kpaged.paged_flash_attention_fwd(qp, kp, vp, tables, lens)
    with pytest.raises(ValueError, match="paged inhibitor kernel: group"):
        kpaged.paged_flash_inhibitor_fwd(qp, kp, vp, tables, lens)
    qp, kp, vp, _, tables, lens = _case(
        11, batch=2, heads=4, kv_heads=2, d=16, ps=8, width=2,
        lengths=[9, 4], dtype=torch.float32)
    flat = torch.empty(qp.numel() + 1, dtype=qp.dtype, device="cuda")
    shifted = flat[1:].view(qp.shape).copy_(qp)
    for fwd in (kpaged.paged_flash_attention_fwd,
                kpaged.paged_flash_inhibitor_fwd):
        with pytest.raises(ValueError, match="aligned"):
            fwd(shifted, kp, vp, tables, lens)
    assert kpaged.counts()["paged_attention"] == 0
    assert kpaged.counts()["paged_inhibitor"] == 0


@pytest.mark.cuda
def test_prefill_wrappers_count_launches_and_reject_bad_operands():
    _needs_card()
    q, k, v = _prefill_operands(4, batch=1, n=40, heads=4, kv_heads=2, d=16,
                                dtype=torch.float32, qk_std=0.25)
    kops.reset_counts()
    kinh.flash_inhibitor_fwd(q, k, v)
    kflash.flash_attention_fwd(q, k, v)
    c = kops.counts()
    assert (c["flash_inhibitor"], c["flash_attention"],
            c["flash_inhibitor_plain"], c["flash_attention_plain"]) == (
        1, 1, 0, 0)
    with pytest.raises(TypeError, match="share"):
        kinh.flash_inhibitor_fwd(q.bfloat16(), k, v)
    with pytest.raises(ValueError, match="contiguous"):
        kinh.flash_inhibitor_fwd(q.transpose(1, 2).contiguous()
                                 .transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="one CUDA device"):
        kflash.flash_attention_fwd(q, k.cpu(), v)
    with pytest.raises(ValueError, match="head_dim"):
        kinh.flash_inhibitor_fwd(q[..., :8].contiguous(),
                                 k[..., :8].contiguous(),
                                 v[..., :8].contiguous())
    assert kops.counts()["flash_inhibitor"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("n", [1, 65, 1000])
def test_flash_inhibitor_tiles_match_plain_version(dtype, d, n):
    """The register-tiled inhibitor at every head_dim (each its own value
    micro-tile), one query, one past a 64-key tile and a ragged 1000:
    causal (diagonal tiles masked, the rest interior), window 1 (each
    query its own key), a window edge inside a key tile (100), no mask
    (interior but the ragged last tile), unnormalized, signed and
    unsigned, with and without the score shift."""
    _needs_card()
    q, k, v = _prefill_operands(13, batch=2, n=n, heads=6, kv_heads=2, d=d,
                                dtype=dtype, qk_std=d ** -0.5)
    for m in (dict(), dict(signed=False), dict(window=1),
              dict(window=100, signed=False), dict(causal=False),
              dict(causal=False, score_shift=0.0),
              dict(normalize=False, signed=False)):
        out = kinh.flash_inhibitor_fwd(q, k, v, **m)
        ref, control = (kinh.flash_inhibitor_plain(q, k, vv, **m)
                        for vv in (v, _late(v)))
        if m.get("normalize", True):
            _check(out, ref, dtype, control, elementwise=True)
        else:   # the plain eq. 9 form cancels sums of up to n terms
            err = (out.float() - ref.float()).abs()
            tol = (1e-5 * max(1.0, ref.float().abs().max().item()) * n / 8
                   + (ULP[dtype] or 0.0) * ref.float().abs())
            assert bool((err <= tol).all()), f"max_abs_err {err.max()}"
            assert not bool(((control.float() - ref.float()).abs()
                             <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_inhibitor_never_reads_past_the_cursor(dtype, d):
    """n_q != n_k with ragged per-row cursors, as the tensor-core test:
    every key past a cursor holds nan, which must enter shared memory as
    zeros and change no bit; the kv_valid_len 0 row outputs 0."""
    _needs_card()
    b, n_q, n_k = 5, 65, 200
    offs = torch.tensor([0, 135, 64, 3, 190], dtype=torch.int32,
                        device="cuda")
    valid = torch.tensor([65, 200, 0, 70, 129], dtype=torch.int32,
                         device="cuda")
    q, _, _ = _prefill_operands(14, batch=b, n=n_q, heads=6, kv_heads=2,
                                d=d, dtype=dtype, qk_std=d ** -0.5)
    _, k, v = _prefill_operands(15, batch=b, n=n_k, heads=6, kv_heads=2,
                                d=d, dtype=dtype, qk_std=d ** -0.5)
    kn, vn = k.clone(), v.clone()
    for row, ln in enumerate(valid.tolist()):
        kn[row, ln:], vn[row, ln:] = float("nan"), float("nan")
    for window, signed in ((None, True), (1, False), (50, True)):
        cur = dict(q_offset=offs, kv_valid_len=valid, window=window,
                   signed=signed)
        out = kinh.flash_inhibitor_fwd(q, kn, vn, **cur)
        assert torch.equal(out, kinh.flash_inhibitor_fwd(q, k, v, **cur))
        ref, control = (kinh.flash_inhibitor_plain(q, k, vv, **cur)
                        for vv in (v, _late(v)))
        _check(out, ref, dtype, control, elementwise=True)
        assert not out[2].any()


@pytest.mark.cuda
def test_flash_ops_gradients_on_the_card():
    """ops.flash_* under autograd on the card: the kernel forward and the
    reference backward against autograd through the plain chunked /
    dense forms (float32).  Compared by norm (1e-4 relative): the two
    inhibitor backward passes sum the score Z in other orders, so a pair
    whose raw score sits within rounding of the shift α may take the
    gate 1[raw > α] on one side only, which moves one row of dq
    discretely."""
    _needs_card()
    from repro_torch.core.dotprod import dot_product_attention
    from repro_torch.core.inhibitor import inhibitor_attention_chunked

    q, k, v = _prefill_operands(5, batch=2, n=200, heads=9, kv_heads=3,
                                d=64, dtype=torch.float32, qk_std=0.125)
    g = torch.randn(q.shape, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(6))
    mask = torch.ones(200, 200, dtype=torch.bool, device="cuda").tril()
    for op, plain in ((kops.flash_inhibitor,
                       lambda *t: inhibitor_attention_chunked(
                           *t, mask=mask, kv_chunk=64)),
                      (kops.flash_attention,
                       lambda *t: dot_product_attention(*t, mask=mask))):
        got = torch.autograd.grad(
            op(*(x.requires_grad_() for x in (q, k, v))), (q, k, v), g)
        want = torch.autograd.grad(plain(q, k, v), (q, k, v), g)
        for a, b in zip(got, want):
            assert b.abs().max() > 1e-2
            assert ((a - b).norm() / b.norm()).item() <= 1e-4


# (t, heads, head_dim, chunk): the reference's sweep (tests/test_kernels.py),
# t below one chunk, t = 1 and t = 0, and rwkv6-7b's heads at a ragged t;
# then the tensor-core kernel's edges (chip_smoke.py WKV_CASES): a last
# chunk of 24 (ending inside a 16-row tile), chunks of 16 and 64, a chunk
# of 20 (padded to 32 inside), head_dim 8 / 16 / 32 / 64 at a tail of 8
WKV_SHAPES = [(50, 3, 16, 16), (32, 2, 8, 8), (17, 1, 16, 32), (5, 2, 64, 32),
              (1, 2, 64, 32), (0, 2, 64, 32), (300, 4, 64, 32),
              (70, 2, 32, 64), (88, 4, 64, 32), (100, 4, 64, 16),
              (150, 4, 64, 64), (70, 4, 32, 20), (40, 4, 8, 32),
              (40, 4, 16, 32), (40, 4, 32, 32), (40, 4, 64, 32)]
# float32 throughout the kernel: the plain version forms the same
# exponents by segment sums rather than differences of cumulative sums
# and sums in another order, so 5e-5 of the largest magnitude
WKV_REL = 5e-5


def _wkv_operands(seed, b, t, h, n, dtype, decay="mixed"):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    r, k, v = (mk(b, t, h, n).to(dtype) for _ in range(3))
    if decay == "zero":
        w = torch.zeros((b, t, h, n), device="cuda")
    elif decay == "near_one":
        w = torch.exp(-torch.exp(mk(b, t, h, n) - 6.0))
    else:
        w = torch.exp(-torch.exp(mk(b, t, h, n) * 2.0))
    return r, k, v, w, mk(h, n)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WKV_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decay", ["mixed", "zero", "near_one"])
def test_wkv6_kernel_matches_plain_version(shape, dtype, decay):
    """Outputs and final state; non-vacuous: a share of the reference above
    the tolerance, and the reference with V one step late (at t = 1: V of
    the other batch row) or u zeroed outside it."""
    _needs_card()
    t, h, n, chunk = shape
    r, k, v, w, u = _wkv_operands(7, 2, t, h, n, dtype, decay)
    out, state = krwkv6.wkv6_chunked(r, k, v, w, u, chunk=chunk)
    ref_o, ref_s = krwkv6.wkv6_chunked_plain(r, k, v, w, u, chunk=chunk)
    assert out.dtype == state.dtype == torch.float32
    assert torch.isfinite(out).all() and torch.isfinite(state).all()
    for got, ref in ((out, ref_o), (state, ref_s)):
        assert got.shape == ref.shape
        if ref.numel():
            tol = WKV_REL * max(1.0, ref.abs().max().item())
            assert (got - ref).abs().max().item() <= tol
    if t == 0:
        assert not state.any()
        return
    tol = WKV_REL * max(1.0, ref_o.abs().max().item())
    assert (ref_o.abs() > tol).float().mean().item() >= MIN_NONZERO_SHARE
    late = v.roll(1, dims=1 if t > 1 else 0)
    for ctl in (krwkv6.wkv6_chunked_plain(r, k, late, w, u, chunk=chunk)[0],
                krwkv6.wkv6_chunked_plain(r, k, v, w, 0 * u,
                                          chunk=chunk)[0]):
        assert (ctl - ref_o).abs().max().item() > tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_takes_operands_off_16_byte_alignment(dtype):
    """Contiguous views one element into their storage are not 16-byte
    aligned: the kernel stages them by plain loads instead of cp.async,
    and computes the same."""
    _needs_card()
    ops = _wkv_operands(12, 2, 70, 4, 64, dtype)

    def shifted(x):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        y = buf[1:].view(x.shape)
        y.copy_(x)
        return y

    moved = [shifted(x) for x in ops[:4]] + [ops[4]]
    assert all(x.data_ptr() % 16 for x in moved[:4])
    out, state = krwkv6.wkv6_chunked(*moved)
    ref_o, ref_s = krwkv6.wkv6_chunked_plain(*ops)
    for got, ref in ((out, ref_o), (state, ref_s)):
        tol = WKV_REL * max(1.0, ref.abs().max().item())
        assert (got - ref).abs().max().item() <= tol


@pytest.mark.cuda
def test_wkv6_wrapper_counts_launches_and_rejects_bad_operands():
    _needs_card()
    r, k, v, w, u = _wkv_operands(8, 1, 40, 2, 64, torch.bfloat16)
    kops.reset_counts()
    krwkv6.wkv6_chunked(r, k, v, w, u)
    assert (kops.counts()["wkv6"], kops.counts()["wkv6_plain"]) == (1, 0)
    with pytest.raises(TypeError, match="share"):
        krwkv6.wkv6_chunked(r.float(), k, v, w, u)
    with pytest.raises(TypeError, match="float32"):
        krwkv6.wkv6_chunked(r, k, v, w.bfloat16(), u)
    with pytest.raises(ValueError, match="contiguous"):
        krwkv6.wkv6_chunked(r.transpose(1, 2).contiguous().transpose(1, 2),
                            k, v, w, u)
    with pytest.raises(ValueError, match="one CUDA device"):
        krwkv6.wkv6_chunked(r, k.cpu(), v, w, u)
    with pytest.raises(ValueError, match="head_dim"):
        krwkv6.wkv6_chunked(*(x[..., :48].contiguous()
                              for x in (r, k, v, w, u)))
    assert kops.counts()["wkv6"] == 1


@pytest.mark.cuda
def test_wkv6_ops_gradients_on_the_card():
    """ops.wkv6 under autograd on the card (the kernel forward, the
    chunk-by-chunk backward) against autograd through the exact scan,
    float32, by norm (1e-4 relative); the decay exp(-exp(N(0, 1))) stays
    above the kernel's 1e-30 floor."""
    _needs_card()
    from repro_torch.nn.ssm import wkv6_scan_ref

    r, k, v, _, u = _wkv_operands(9, 2, 100, 3, 64, torch.float32)
    w = torch.exp(-torch.exp(torch.randn(
        r.shape, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(10))))
    g = torch.randn(r.shape, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(11))
    leaves = [x.requires_grad_() for x in (r, k, v, w, u)]
    kops.reset_counts()
    got = torch.autograd.grad(kops.wkv6(*leaves)[0], leaves, g)
    assert kops.counts()["wkv6"] == 1 and kops.counts()["wkv6_plain"] == 0
    want = torch.autograd.grad(wkv6_scan_ref(*leaves)[0], leaves, g)
    for a, b in zip(got, want):
        assert b.abs().max() > 1e-3
        assert ((a - b).norm() / b.norm()).item() <= 1e-4
