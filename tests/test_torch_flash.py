"""The port's blockwise flash kernels' plain versions and training ops
against the JAX package on the same numpy inputs.

(a) ``flash_inhibitor_plain`` / ``flash_attention_plain`` (what the CUDA
    kernels are held against on the card, and what the wrappers run on
    the CPU) and the oracles ``kernels.ref.flash_*_ref`` against the JAX
    kernels ``flash_inhibitor_fwd`` / ``flash_attention_fwd`` run as
    ``tests/test_kernels.py`` runs them (``interpret=True``): signed /
    unsigned, shift, window, causal or not, GQA, ragged n, and the per-row
    cursor form.
(b) the CUDA inhibitor kernel's arithmetic, in float32 torch: its
    sign-folded value term sgn(v) relu(|v| - z) against the signed branch
    form v > 0 ? relu(v - z) : min(v + z, 0), bit for bit; then that
    term summed over keys, masked pairs given z = +inf and V past a
    cursor zeroed as the kernel does, against ``flash_inhibitor_plain``.
(c) ``kernels.ops.flash_inhibitor`` / ``flash_attention`` gradients (the
    kernel's forward, the reference's backward) against ``jax.grad`` of
    the JAX ops.

Inputs are live: q and k of stddev 1/sqrt(d) for the inhibitor, so the
score Z = sum_d |q - k| / sqrt(d) - 0.5 is about 0.6 and the inhibition
is materially nonzero (at unit scale every output would be 0).

Tolerances: (a) and the sums of (b) float32, summation order only: atol
1e-5, rtol 1e-5; the unnormalized inhibitor sums (up to n terms of size
|V| + Z, cancelled in the eq. 9/10 forms of both sides) atol 1e-4.  (c) rtol 1e-4, atol 1e-5,
as ``tests/test_kernels.py::test_ops_grads_match_ref``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash import flash_attention_fwd as jax_flash_attention
from repro.kernels.inhibitor import flash_inhibitor_fwd as jax_flash_inhibitor
from repro_torch.core import mechanism as tmech
from repro_torch.core.attention import AttentionConfig
from repro_torch.kernels import flash as kflash
from repro_torch.kernels import inhibitor as kinh
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
BLOCKS = dict(block_q=16, block_k=16)


def _operands(seed, b, n_q, n_k, h, hk, d, qk_std):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, n_q, h, d)) * qk_std).astype(np.float32)
    k = (rng.normal(size=(b, n_k, hk, d)) * qk_std).astype(np.float32)
    v = rng.normal(size=(b, n_k, hk, d)).astype(np.float32)
    return q, k, v


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


# (kwargs, heads, kv_heads, n): signed / unsigned, shift, window, causal,
# GQA, ragged n (37: neither block divides it)
INHIBITOR_CASES = {
    "signed_causal_gqa": (dict(signed=True), 6, 2, 37),
    "unsigned_causal_gqa": (dict(signed=False), 6, 2, 37),
    "no_shift": (dict(score_shift=0.0), 4, 4, 37),
    "big_shift_unsigned": (dict(score_shift=2.0, signed=False), 4, 2, 24),
    "window": (dict(window=8), 6, 2, 37),
    "window_not_causal": (dict(window=8, causal=False), 4, 2, 37),
    "not_causal": (dict(causal=False), 6, 3, 33),
    "unnormalized": (dict(normalize=False), 6, 2, 37),
    "unnormalized_unsigned": (dict(normalize=False, signed=False), 4, 2, 37),
}


@pytest.mark.parametrize("case", sorted(INHIBITOR_CASES))
def test_flash_inhibitor_plain_matches_jax_kernel(case):
    kw, h, hk, n = INHIBITOR_CASES[case]
    (jq, jk, jv), (tq, tk, tv) = _both(*_operands(0, 2, n, n, h, hk, 16,
                                                  16 ** -0.5))
    ref = np.asarray(jax_flash_inhibitor(jq, jk, jv, sub_k=8, interpret=True,
                                         **BLOCKS, **kw))
    kinh.flash_inhibitor_plain.calls = 0
    out = kinh.flash_inhibitor_fwd(tq, tk, tv, **kw).numpy()
    assert kinh.flash_inhibitor_plain.calls == 1   # the CPU's plain version
    assert np.abs(ref).max() > 0.05                # live, not all zero
    tol = TOL if kw.get("normalize", True) else dict(rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(out, ref, **tol)
    np.testing.assert_allclose(
        kref.flash_inhibitor_ref(tq, tk, tv, **kw).numpy(), ref, **tol)


ATTENTION_CASES = {
    "causal_gqa": (dict(), 6, 2, 37),
    "window": (dict(window=8), 6, 2, 37),
    "not_causal": (dict(causal=False), 4, 4, 33),
    "scaled": (dict(score_scale=2.0), 6, 3, 24),
}


@pytest.mark.parametrize("case", sorted(ATTENTION_CASES))
def test_flash_attention_plain_matches_jax_kernel(case):
    kw, h, hk, n = ATTENTION_CASES[case]
    (jq, jk, jv), (tq, tk, tv) = _both(*_operands(1, 2, n, n, h, hk, 16, 1.0))
    ref = np.asarray(jax_flash_attention(jq, jk, jv, interpret=True,
                                         **BLOCKS, **kw))
    out = kflash.flash_attention_fwd(tq, tk, tv, **kw).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(
        kref.flash_attention_ref(tq, tk, tv, **kw).numpy(), ref, **TOL)


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("mech", ["inhibitor", "attention"])
def test_cursor_form_matches_jax_kernel(mech, window):
    """Per-row q_offset / kv_valid_len, including a row with no live key
    (both kernels output 0 there)."""
    q, k, v = _operands(2, 4, 5, 40, 6, 2, 16,
                        16 ** -0.5 if mech == "inhibitor" else 1.0)
    offs = np.asarray([0, 13, 30, 2], np.int32)
    valid = np.asarray([5, 18, 40, 0], np.int32)
    (jq, jk, jv, joff, jval), (tq, tk, tv, toff, tval) = _both(
        q, k, v, offs, valid)
    if mech == "inhibitor":
        ref = jax_flash_inhibitor(jq, jk, jv, q_offset=joff,
                                  kv_valid_len=jval, window=window, sub_k=8,
                                  interpret=True, **BLOCKS)
        out = kinh.flash_inhibitor_fwd(tq, tk, tv, q_offset=toff,
                                       kv_valid_len=tval, window=window)
    else:
        ref = jax_flash_attention(jq, jk, jv, q_offset=joff,
                                  kv_valid_len=jval, window=window,
                                  interpret=True, **BLOCKS)
        out = kflash.flash_attention_fwd(tq, tk, tv, q_offset=toff,
                                         kv_valid_len=tval, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert not out[3].any() and np.abs(np.asarray(ref)).max() > 0.05


def test_pack_cursors_broadcasts_scalars():
    cur = kinh.pack_cursors(3, 4, None, 10, "cpu")
    assert cur.dtype == torch.int32
    assert cur.tolist() == [[4, 4, 4], [10, 10, 10]]
    cur = kinh.pack_cursors(2, torch.tensor([1, 2]), torch.tensor(7), 10,
                            "cpu")
    assert cur.tolist() == [[1, 2], [7, 7]]


def _term_operands(seed):
    """v (64, 1) with zeros of both signs, z (1, 256) >= 0 with zeros,
    values past |v|, 1e30 and +inf (the kernel's masked pairs)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(64, 1)).astype(np.float32) * 3
    v[::8], v[1::8] = 0.0, -0.0
    z = np.abs(rng.normal(size=(1, 256))).astype(np.float32) * 2
    z[:, ::16], z[:, 1::16], z[:, 2::16] = 0.0, 1e30, np.inf
    return torch.from_numpy(v), torch.from_numpy(z)


def test_sign_folded_term_equals_the_branch_form_bit_for_bit():
    """For z >= 0, sgn(v) relu(|v| - z) and v > 0 ? relu(v - z) :
    min(v + z, 0) are the same float (for v < 0, -(v + z) and |v| - z
    round alike), up to the sign of a zero result, which adds nothing to
    a sum; over v with zeros of both signs and z with zeros, values past
    |v|, 1e30 and +inf (the kernel's masked pairs)."""
    v, z = _term_operands(11)
    branch = torch.where(v > 0, torch.relu(v - z),
                         torch.clamp(v + z, max=0.0))
    folded = torch.copysign(torch.ones_like(v), v) * torch.relu(v.abs() - z)
    assert bool((branch != 0).float().mean() > 0.2)
    assert torch.equal((folded + 0.0).view(torch.int32),
                       (branch + 0.0).view(torch.int32))


def test_min_form_term_equals_the_branch_form_bit_for_bit():
    """For z >= 0, v - sgn(v) min(|v|, z) (the kernel's form on a tile
    every query attends) and v > 0 ? relu(v - z) : min(v + z, 0) are the
    same float, and unsigned v - min(v, z) is relu(v - z), up to the sign
    of a zero result; z = +inf gives 0 too.  Over v with zeros of both
    signs and z with zeros, values past |v|, 1e30 and +inf."""
    v, z = _term_operands(12)
    sg = torch.copysign(torch.ones_like(v), v)
    pairs = (
        (torch.where(v > 0, torch.relu(v - z), torch.clamp(v + z, max=0.0)),
         v - sg * torch.minimum(v.abs(), z)),
        (torch.relu(v - z), v - torch.minimum(v, z)))
    for branch, min_form in pairs:
        assert bool((branch != 0).float().mean() > 0.2)
        assert torch.equal((min_form + 0.0).view(torch.int32),
                           (branch + 0.0).view(torch.int32))


def _folded_setup(q, k, v, *, causal, window, q_offset, kv_valid_len):
    """z (b, h, n_q, n_k, 1) = relu(sum |q - k| / sqrt(d) - 0.5), +inf for
    a masked pair; V (b, h, 1, n_k, d) zeroed past each row's cursor; the
    mask, broadcastable to (b, h, n_q, n_k)."""
    b, n_q, h, d = q.shape
    n_k, hk = k.shape[1], k.shape[2]
    cursors = kinh._cursors_or_none(q, k, q_offset, kv_valid_len)
    mask = kref.prefill_mask(n_q, n_k, causal=causal, window=window,
                             cursors=cursors)
    if mask is None:
        mask = torch.ones(1, 1, n_q, n_k, dtype=torch.bool)
    if cursors is not None:
        live = torch.arange(n_k)[None, :] < cursors[1].long()[:, None]
        v = torch.where(live[:, :, None, None], v, torch.zeros_like(v))
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(h // hk, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(h // hk, dim=2).transpose(1, 2)
    z = torch.relu((qt[..., :, None, :] - kt[..., None, :, :]).abs().sum(-1)
                   * (1.0 / d ** 0.5) - 0.5)
    z = torch.where(mask, z, torch.full_like(z, torch.inf))[..., None]
    return z, vt[..., None, :, :], mask


def _folded_inhibitor(q, k, v, *, signed, normalize, causal=True,
                      window=None, q_offset=None, kv_valid_len=None):
    """The kernel's arithmetic on a tile with masked pairs, over all
    pairs: out = sum_j sgn(v) relu(|v| - z) (unsigned: relu(v - z)) /
    max(count, 1)."""
    z, vj, mask = _folded_setup(q, k, v, causal=causal, window=window,
                                q_offset=q_offset, kv_valid_len=kv_valid_len)
    if signed:
        terms = torch.copysign(torch.ones_like(vj), vj) * torch.relu(
            vj.abs() - z)
    else:
        terms = torch.relu(vj - z)
    out = terms.sum(-2)
    if normalize:
        out = out / mask.sum(-1, keepdim=True).clamp(min=1)
    return out.transpose(1, 2)


def _tiled_inhibitor(q, k, v, *, tile, signed, normalize, causal=True,
                     window=None, q_offset=None, kv_valid_len=None):
    """The kernel's arithmetic tile by tile, with `tile` queries x `tile`
    keys: on a whole key tile that every query of the block attends, sum_j
    -sgn(v) min(|v|, z) (unsigned: -min(v, z)) plus the tile's sum of v;
    on any other, the relu form.  Returns (out, interior tiles taken)."""
    z, vj, mask = _folded_setup(q, k, v, causal=causal, window=window,
                                q_offset=q_offset, kv_valid_len=kv_valid_len)
    n_q, n_k = z.shape[2], z.shape[3]
    out = torch.zeros(z.shape[:3] + vj.shape[-1:])
    n_interior = 0
    for q0 in range(0, n_q, tile):
        for k0 in range(0, n_k, tile):
            qs, ks = slice(q0, q0 + tile), slice(k0, k0 + tile)
            interior = mask[..., qs, ks].flatten(-2).all(-1)
            if k0 + tile > n_k:
                interior = torch.zeros_like(interior)
            vs, zs = vj[..., ks, :], z[..., qs, ks, :]
            sg = torch.copysign(torch.ones_like(vs), vs) if signed else 1.0
            av = vs.abs() if signed else vs
            relu_form = (sg * torch.relu(av - zs)).sum(-2)
            min_form = (-sg * torch.minimum(av, zs)).sum(-2) + vs.sum(-2)
            out[..., qs, :] += torch.where(interior[..., None, None],
                                           min_form, relu_form)
            n_interior += int(interior.sum())
    if normalize:
        out = out / mask.sum(-1, keepdim=True).clamp(min=1)
    return out.transpose(1, 2), n_interior


# (kwargs, n_q, n_k): the kernel's mask branches
FOLDED_CASES = {
    "causal": (dict(), 37, 37),
    "window": (dict(window=8), 37, 37),
    "not_causal": (dict(causal=False), 33, 33),
    "cursors": (dict(q_offset=torch.tensor([0, 13, 30, 2], dtype=torch.int32),
                     kv_valid_len=torch.tensor([5, 18, 40, 0],
                                               dtype=torch.int32)), 5, 40),
    "unnormalized": (dict(normalize=False), 37, 37),
}


def _check_against_plain(case, signed, form):
    """form(q, k, v, **kw) -> out against flash_inhibitor_plain on the
    case's inputs, with nan past every cursor."""
    kw, n_q, n_k = FOLDED_CASES[case]
    b = 4 if "q_offset" in kw else 2
    q, _, _ = _operands(7, b, n_q, n_k, 6, 2, 16, 16 ** -0.5)
    _, k, v = _operands(8, b, n_k, n_k, 6, 2, 16, 16 ** -0.5)
    q, k, v = map(torch.from_numpy, (q, k, v))
    kw = dict(kw, signed=signed)
    kw.setdefault("normalize", True)
    ref = kinh.flash_inhibitor_plain(q, k, v, **kw)
    if "kv_valid_len" in kw:    # nan past every cursor reaches no sum
        for row, ln in enumerate(kw["kv_valid_len"].tolist()):
            k[row, ln:], v[row, ln:] = float("nan"), float("nan")
    out = form(q, k, v, **kw)
    assert np.abs(ref.numpy()).max() > 0.05
    tol = TOL if kw["normalize"] else dict(rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **tol)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("case", sorted(FOLDED_CASES))
def test_folded_inhibitor_matches_plain_version(signed, case):
    _check_against_plain(case, signed, _folded_inhibitor)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("case", sorted(FOLDED_CASES))
def test_tiled_min_form_matches_plain_version(signed, case):
    """The kernel's two forms together: the min form on interior tiles,
    the relu form with inf masks elsewhere (4 x 4 tiles, at least one
    interior)."""
    def tiled(q, k, v, **kw):
        out, n_interior = _tiled_inhibitor(q, k, v, tile=4, **kw)
        assert n_interior > 0
        return out

    _check_against_plain(case, signed, tiled)


def _key_ranges(n_q, n_k, *, causal, window, q_offset):
    """Each query's attended keys [lo, hi) in closed form, as the kernels
    take them: query i at q_offset + i, every key valid, a window implies
    causality."""
    pos = q_offset + torch.arange(n_q)
    lo, hi = torch.zeros(n_q, dtype=torch.long), torch.full((n_q,), n_k)
    if causal or window is not None:
        hi = torch.minimum(hi, pos + 1)
    if window is not None:
        lo = torch.clamp(pos - window + 1, min=0)
    return lo, hi


def _mirror_bwd(q, k, v, g, *, tile, signed, normalize, causal=True,
                window=None, q_offset=0, score_shift=0.5):
    """The backward kernel's decomposition in float32 torch, tile by tile:
    per query tile, Z (+inf on masked pairs) and t of each pair over a
    key tile, then pass B's dq = sum_j t sign(q - k) over the union of
    its queries' key ranges; per key tile and kv head, pass A's dk = sum_i
    t sign(k - q) and dv = sum_i g / count [|v| > Z] over the group's
    query heads in order and the query tiles that attend its keys (closed
    form).  sign(0) is 0; the gate 1[raw > alpha] is Z > 0."""
    b, n_q, h, d = q.shape
    n_k, hk = k.shape[1], k.shape[2]
    group = h // hk
    inv = torch.tensor(1.0 / d ** 0.5, dtype=torch.float32)
    lo, hi = _key_ranges(n_q, n_k, causal=causal, window=window,
                         q_offset=q_offset)
    ic = (1.0 / torch.clamp(hi - lo, min=1).float() if normalize
          else torch.ones(n_q))

    def pair(head, i0, j0):
        """(Z, t, ind) of queries [i0, i0 + tile) of ``head`` against keys
        [j0, j0 + tile) of its kv head: (b, tq, tk), (b, tq, tk, d)."""
        i = torch.arange(i0, min(i0 + tile, n_q))
        j = torch.arange(j0, min(j0 + tile, n_k))
        qt, gt = q[:, i, head], g[:, i, head]
        kt, vt = k[:, j, head // group], v[:, j, head // group]
        raw = (qt[:, :, None] - kt[:, None]).abs().sum(-1) * inv
        z = torch.relu(raw - score_shift) if score_shift else raw
        live = (j[None] >= lo[i, None]) & (j[None] < hi[i, None])
        z = torch.where(live, z, torch.inf)
        av = vt.abs() if signed else vt
        sg = torch.where(vt > 0, 1.0, -1.0) if signed else torch.ones_like(vt)
        ind = (av[:, None] > z[..., None]).float()
        t = -(ind * sg[:, None] * gt[:, :, None]).sum(-1) * inv * ic[i, None]
        if score_shift:
            t = torch.where(z > 0, t, torch.zeros_like(t))
        return z, t, ind, i, j

    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for head in range(h):                          # pass B
        for i0 in range(0, n_q, tile):
            i_last = min(i0 + tile, n_q) - 1
            for j0 in range(int(lo[i0]) // tile * tile, int(hi[i_last]),
                            tile):
                _, t, _, i, j = pair(head, i0, j0)
                sgn = torch.sign(q[:, i, None, head] - k[:, None, j,
                                                         head // group])
                dq[:, i, head] += (t[..., None] * sgn).sum(2)
    for kvh in range(hk):                          # pass A
        for j0 in range(0, n_k, tile):
            j1 = min(j0 + tile, n_k)
            i_first = (max(0, j0 - q_offset) if causal or window is not None
                       else 0)
            i_end = (n_q if window is None
                     else min(n_q, max(0, j1 + window - 1 - q_offset)))
            for head in range(kvh * group, (kvh + 1) * group):
                for i0 in range(i_first // tile * tile, i_end, tile):
                    _, t, ind, i, j = pair(head, i0, j0)
                    sgn = torch.sign(k[:, None, j, kvh]
                                     - q[:, i, None, head])
                    dk[:, j, kvh] += (t[..., None] * sgn).sum(1)
                    gh = g[:, i, head] * ic[i, None]
                    dv[:, j, kvh] += (ind * gh[:, :, None]).sum(1)
    return dq, dk, dv


def _naive_grads(q, k, v, g, *, signed, normalize, causal=True, window=None,
                 q_offset=0):
    """Autograd through the eq. 6 / 7 oracles (``inhibit_naive`` /
    ``inhibit_signed_naive``) under the training entries' mask."""
    from repro_torch.core import inhibitor as tinh

    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    qq, kk, vv = leaves
    b, n_q, h, d = q.shape
    group = h // k.shape[2]
    qt = qq.transpose(1, 2)
    kt = kk.repeat_interleave(group, dim=2).transpose(1, 2)
    vt = vv.repeat_interleave(group, dim=2).transpose(1, 2)
    z = tinh.manhattan_scores(qt, kt, score_shift=0.5)
    mask = kref.backward_mask(q, k, causal, window, q_offset)
    if mask is not None:
        z = tinh.mask_scores(z, mask)
    naive = tinh.inhibit_signed_naive if signed else tinh.inhibit_naive
    out = naive(vt, z)
    if normalize:
        cnt = (mask.expand(b, h, n_q, k.shape[1]).float().sum(-1)
               if mask is not None else torch.full((b, h, n_q), k.shape[1]))
        out = out / cnt.clamp(min=1)[..., None]
    return torch.autograd.grad(out.transpose(1, 2), leaves, g)


def _grid(x, step=2.0 ** -6):
    """x on a grid of ``step``: every sum of |q - k| is then exact in
    float32, so Z (and each indicator and gate) is the same bits whatever
    order the sum takes."""
    return torch.round(x / step) * step


# (kwargs, n_q, n_k, heads, kv_heads): every mask form the training
# entries take, ragged against the 8-row tiles, groups 1, 3 and 4
BWD_CASES = {
    "causal_gqa": (dict(), 37, 37, 6, 2),
    "not_causal": (dict(causal=False), 33, 33, 3, 3),
    "window": (dict(window=8), 37, 37, 8, 2),
    "window_edge_in_tile": (dict(window=13, signed=False), 37, 37, 6, 2),
    "q_offset": (dict(q_offset=20), 17, 37, 6, 2),
    "q_offset_window": (dict(q_offset=19, window=7), 18, 37, 6, 2),
    "q_offset_not_causal": (dict(q_offset=8, causal=False), 9, 25, 4, 4),
    "unnormalized_unsigned": (dict(normalize=False, signed=False), 37, 37,
                              6, 2),
}


def _assert_grads_close(got, want, allow=(0.0, 0.0, 0.0)):
    """Each of dq, dk, dv within GRAD_TOL of ``want``, plus ``allow`` (the
    tie allowance, ``kernels.ref.inhibitor_bwd_tie_allowance``)."""
    for name, a, w, extra in zip(("dq", "dk", "dv"), got, want, allow):
        err = (a - w).abs() - extra
        tol = GRAD_TOL["atol"] + GRAD_TOL["rtol"] * w.abs()
        assert bool((err <= tol).all()), \
            f"{name}: {float((err - tol).max())} beyond the tolerance"


@pytest.mark.parametrize("inputs", ["grid", "free"])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_backward_mirror_matches_plain_vjp_and_naive_autograd(case, inputs):
    """The kernel's two-pass decomposition (8-row tiles) against the plain
    VJP and against autograd through the naive oracles, dq, dk and dv
    within float32 summation order (stddev 1/sqrt(d)).  On a 2^-6 grid
    (ties q = k included) the three compute Z alike and no indicator or
    gate sits on the other side of a tie; on free inputs the tie allowance
    is added, for pairs within rounding of one."""
    kw, n_q, n_k, h, hk = BWD_CASES[case]
    kw = dict(kw)
    signed, normalize = kw.pop("signed", True), kw.pop("normalize", True)
    q, k, v = map(torch.from_numpy, _operands(21, 2, n_q, n_k, h, hk, 16,
                                              16 ** -0.5))
    g = torch.from_numpy(np.random.default_rng(22).normal(
        size=q.shape).astype(np.float32))
    allow = (0.0, 0.0, 0.0)
    if inputs == "grid":
        q, k = _grid(q), _grid(k)
        assert bool((q[:, :, None, :1] == k[:, None, :, :1]).any())  # ties
    else:
        allow = kref.inhibitor_bwd_tie_allowance(
            q, k, v, g, signed=signed, normalize=normalize, **kw)[:3]
    got = _mirror_bwd(q, k, v, g, tile=8, signed=signed, normalize=normalize,
                      **kw)
    plain = kinh.flash_inhibitor_bwd_plain(q, k, v, g, signed=signed,
                                           normalize=normalize, **kw)
    naive = _naive_grads(q, k, v, g, signed=signed, normalize=normalize,
                         **kw)
    for p in plain:
        assert p.abs().max() > 1e-2
    _assert_grads_close(got, plain, allow)
    _assert_grads_close(got, naive, allow)


def test_tie_allowance_covers_another_summation_order():
    """The plain VJP with q's and k's head dims permuted (so every score
    is summed in another order) against the plain VJP, within float32
    summation order plus the tie allowance; the shape holds ties, and the
    allowance stays small beside each gradient (by norm under 2%)."""
    q, k, v = map(torch.from_numpy, _operands(25, 2, 192, 192, 4, 2, 32,
                                              32 ** -0.5))
    g = torch.from_numpy(np.random.default_rng(26).normal(
        size=q.shape).astype(np.float32))
    perm = torch.from_numpy(np.random.default_rng(27).permutation(32))
    want = kinh.flash_inhibitor_bwd_plain(q, k, v, g)
    dq, dk, dv = kinh.flash_inhibitor_bwd_plain(
        q[..., perm].contiguous(), k[..., perm].contiguous(), v, g)
    inv = torch.argsort(perm)
    got = (dq[..., inv], dk[..., inv], dv)
    *allow, ties = kref.inhibitor_bwd_tie_allowance(q, k, v, g)
    assert int(ties) > 0
    _assert_grads_close(got, want, allow)
    for a, w in zip(allow, want):
        assert float(a.expand_as(w).norm()) <= 0.02 * float(w.norm())


@pytest.mark.parametrize("signed", [True, False])
def test_tie_allowance_holds_a_pair_placed_on_its_tie(signed):
    """A value set to its pair's exact Z (and a score set to the shift)
    gets at least its term's allowance: |g^| on dv, |g^| / gamma on the
    query's dq and the key's dk; the gate's sum_k |g^| / gamma."""
    q, k, v = map(torch.from_numpy, _operands(28, 1, 12, 12, 2, 1, 16,
                                              0.25))
    g = torch.from_numpy(np.random.default_rng(29).normal(
        size=q.shape).astype(np.float32))
    i, j, c, gamma = 9, 4, 5, 4.0
    raw = float((q[0, i, 0].double() - k[0, j, 0].double()).abs().sum())
    v[0, j, 0, c] = (1.0 if signed else -1.0) * (raw / gamma - 0.5)
    aq, ak, av, ties = kref.inhibitor_bwd_tie_allowance(q, k, v, g,
                                                        signed=signed)
    term = abs(float(g[0, i, 0, c])) / (i + 1)          # g / count, causal
    if not signed:                 # unsigned: only v > Z can tie
        assert float(av[0, j, 0, c]) < term and int(ties) == 0
        return
    assert int(ties) >= 1 and float(av[0, j, 0, c]) >= term
    assert float(aq[0, i, 0, 0]) >= term / gamma
    assert float(ak[0, j, 0, 0]) >= term / gamma
    # the gate: key j's raw score against query i's at the shift
    q2 = q.clone()
    q2[0, i, 0] = k[0, j, 0]
    q2[0, i, 0, 0] += 0.5 * gamma
    aq2, ak2, _, _ = kref.inhibitor_bwd_tie_allowance(q2, k, v, g)
    whole = float(g[0, i, 0].double().abs().sum()) / (i + 1) / gamma
    assert float(aq2[0, i, 0, 0]) >= whole
    assert float(ak2[0, j, 0, 0]) >= whole


def test_cpu_backward_takes_the_plain_vjp():
    """On CPU tensors ``ops.flash_inhibitor``'s backward is the plain VJP,
    unchanged: one plain call a backward, no kernel launch, and the
    gradients of the plain VJP itself."""
    q, k, v = map(torch.from_numpy, _operands(23, 2, 24, 24, 4, 2, 16,
                                              16 ** -0.5))
    g = torch.from_numpy(np.random.default_rng(24).normal(
        size=q.shape).astype(np.float32))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    kops.reset_counts()
    got = torch.autograd.grad(kops.flash_inhibitor(*leaves, window=6,
                                                   q_offset=0), leaves, g)
    c = kops.counts()
    assert (c["flash_inhibitor_bwd"], c["flash_inhibitor_bwd_plain"]) == (0, 1)
    want = kinh.flash_inhibitor_bwd_plain(q, k, v, g, window=6)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


# (op, kwargs, heads, kv_heads)
GRAD_CASES = {
    "inhibitor_signed": ("inhibitor", dict(), 4, 2),
    "inhibitor_unsigned_window": ("inhibitor",
                                  dict(signed=False, window=6), 4, 2),
    "inhibitor_unnormalized": ("inhibitor", dict(normalize=False), 4, 4),
    "attention": ("attention", dict(), 4, 2),
    "attention_window": ("attention", dict(window=6), 6, 3),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_ops_gradients_match_jax(case):
    op, kw, h, hk = GRAD_CASES[case]
    std = 16 ** -0.5 if op == "inhibitor" else 1.0
    q, k, v = _operands(3, 2, 24, 24, h, hk, 16, std)
    g = np.random.default_rng(4).normal(size=q.shape).astype(np.float32)
    jfn = jops.flash_inhibitor if op == "inhibitor" else jops.flash_attention
    tfn = kops.flash_inhibitor if op == "inhibitor" else kops.flash_attention
    jkw = dict(kw)
    if op == "inhibitor":
        args = (None, 0.5, jkw.pop("signed", True),
                jkw.pop("normalize", True), True, jkw.pop("window", None))
    else:
        args = (None, True, jkw.pop("window", None))
    _, vjp = jax.vjp(lambda *x: jfn(*x, *args), *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(tfn(*leaves, *args), leaves,
                              torch.from_numpy(g))
    for a, r in zip(got, ref):
        assert np.abs(np.asarray(r)).max() > 1e-2
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **GRAD_TOL)


def test_registry_records_decisions_and_rejects_other_key_tiles():
    kops.registry.reset()
    q, k, v = (torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 2, 16),
               torch.zeros(1, 8, 2, 16))
    kops.flash_inhibitor(q, k, v)
    kops.flash_attention_cached(q, k, v, 0, 8,
                                choice=kops.KernelChoice(block_q=8))
    sources = {key[0]: d["source"] for key, d in
               kops.registry.decisions.items()}
    assert sources == {"inhibitor": "default-cpu", "flash": "override"}
    assert all(not d["native"] and d["platform"] == "cpu"
               for d in kops.registry.decisions.values())
    with pytest.raises(ValueError, match="block_k=128"):
        kops.flash_inhibitor(q, k, v, choice=kops.KernelChoice(block_k=128))


@pytest.mark.parametrize("mech", ["inhibitor", "dotprod"])
def test_pallas_backend_runs_the_kernel_wrappers(mech):
    """The planner's ``pallas`` backend on the CPU: the training form
    (no cursors) goes through ``ops.flash_*``, the cursor form through
    ``*_cached``; both reach the plain version, and no ``pallas`` backend
    raises any longer."""
    cfg = AttentionConfig(mechanism=mech, backend="pallas", num_heads=4,
                          num_kv_heads=2, head_dim=16)
    shapes = tmech.AttnShapes(batch=1, n_q=8, n_k=8, num_heads=4,
                              num_kv_heads=2, head_dim=16, platform="cpu")
    plan = tmech.plan_attention(cfg, shapes)
    params = tmech.get_mechanism(mech).make_params()
    q, k, v = _both(*_operands(5, 1, 8, 8, 4, 2, 16, 0.25))[1]
    kops.reset_counts()
    plain_out = tmech.execute_plan(plan, q, k, v, params=params,
                                   structural=tmech.Structural())
    cached_out = tmech.execute_plan(
        plan, q, k, v, params=params,
        structural=tmech.Structural(q_offset=torch.tensor([0]),
                                    kv_valid_len=torch.tensor([8])))
    name = "flash_inhibitor" if mech == "inhibitor" else "flash_attention"
    assert kops.counts()[name + "_plain"] == 2
    assert kops.counts()[name] == 0
    torch.testing.assert_close(plain_out, cached_out, rtol=1e-6, atol=1e-6)
