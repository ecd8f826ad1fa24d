"""The port's lanes (repro_torch.core.lanes) and TFHE simulator
(repro_torch.fhe.tfhe_sim) against the JAX package's, op by op, on the
same numpy inputs: levelled ops with numpy literals, arithmetic shifts of
negatives, table and int_fn lookups, packed bivariate lookups, selects,
row maxima (a fully masked row included), the plaintext-weight and
cipher-cipher products (int32 results that wrap included),
``reciprocal_literal``, the float64 branch of ``exact_int_matmul`` and
its guard, and ``FheContext`` / ``EncTensor`` counts.

Tolerance: the integer lanes and every count bit for bit; the float lane
within float32 rounding (rtol 1e-5, atol 1e-5 · max|ref|), since both
sides compute the same float32 operations in possibly another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lanes as jl
from repro.fhe import tfhe_sim as jsim
from repro_torch.core import lanes as tl
from repro_torch.fhe import tfhe_sim as tsim

LANES = ("int", "fhe_sim", "float")


def _lanes(name):
    return jl.get_lane(name), tl.get_lane(name, device="cpu")


def _check(name, ref_lane, port_lane, ref_out, port_out):
    a = ref_lane.to_numpy(ref_out)
    b = port_lane.to_numpy(port_out)
    assert a.shape == b.shape
    if name == "float":
        np.testing.assert_allclose(
            b, a, rtol=1e-5, atol=1e-5 * max(float(np.abs(a).max()), 1.0))
    else:
        np.testing.assert_array_equal(b, a.astype(b.dtype))
        if name == "int":
            assert b.dtype == np.int32
    if name == "fhe_sim":
        assert port_lane.ctx.summary() == ref_lane.ctx.summary()
        assert port_lane.ctx.scope_report() == ref_lane.ctx.scope_report()
    return a


def _run(name, fn, *arrays):
    """``fn(lane, *handles)`` on the reference lane and the port's."""
    rl, pl = _lanes(name)
    with rl.scope("op"), pl.scope("op"):
        ro = fn(rl, *(rl.array(a) for a in arrays))
        po = fn(pl, *(pl.array(a) for a in arrays))
    return _check(name, rl, pl, ro, po)


LEVELLED = {
    "add_array": lambda l, x: l.add(x, np.arange(-3, 5)),
    "add_scalar": lambda l, x: l.add(x, 7),
    "add_handles": lambda l, x: l.add(x, l.relu(x)),
    "sub_array": lambda l, x: l.sub(x, np.arange(8)[::-1].copy()),
    "sub_scalar": lambda l, x: l.sub(x, np.int64(-5)),
    "mul_literal_array": lambda l, x: l.mul_literal(x, np.arange(-4, 4)),
    "mul_literal_scalar": lambda l, x: l.mul_literal(x, 3),
    "sum_keepdims": lambda l, x: l.sum(x, axis=-1, keepdims=True),
    "sum_axis0": lambda l, x: l.sum(x, axis=0),
    "relu_abs": lambda l, x: l.add(l.relu(x), l.abs(x)),
    "max": lambda l, x: l.max(x, axis=-1, keepdims=True),
    "structure": lambda l, x: l.transpose(l.repeat(l.expand_dims(
        l.reshape(x, (4, 3, 4)), 1), 2, 1), (2, 0, 1, 3)),
}


@pytest.mark.parametrize("op", sorted(LEVELLED))
@pytest.mark.parametrize("name", LANES)
def test_levelled_and_structure_ops_match_reference(rng, name, op):
    x = rng.integers(-200, 200, (6, 8))
    out = _run(name, LEVELLED[op], x)
    assert np.any(out != 0)


@pytest.mark.parametrize("k", [1, 3, 7])
@pytest.mark.parametrize("name", LANES)
def test_shift_right_on_negatives(rng, name, k):
    x = rng.integers(-1000, 1000, (4, 9))
    x[0, :3] = [-1, -(1 << k), -(1 << k) - 1]
    out = _run(name, lambda l, t: l.shift_right(t, k), x)
    if name != "float":
        np.testing.assert_array_equal(out, x >> k)    # floor, not trunc


@pytest.mark.parametrize("name", LANES)
def test_lut_by_table(rng, name):
    x = rng.integers(-40, 40, (3, 16))

    def fn(l, t):
        return l.lut(t, lambda v: (v * v) >> 2, -20, 20,
                     float_fn=lambda v: v * v / 4.0)

    out = _run(name, fn, x)
    if name != "float":
        np.testing.assert_array_equal(out, (np.clip(x, -20, 20) ** 2) >> 2)


@pytest.mark.parametrize("name", ["int", "fhe_sim"])
def test_lut_table_narrowing_and_exp_table(rng, name):
    """The exp2 table of the softmax surrogate, and a table whose int32
    narrowing wraps on the int lane as numpy's astype does."""
    d = rng.integers(-20, 3, (2, 5, 7))
    _run(name, lambda l, t: l.lut(
        t, lambda v: (np.exp2(v.astype(np.float64)) * 256).astype(np.int64),
        -15, 0), d)
    x = rng.integers(-3, 4, (4, 4))
    _run(name, lambda l, t: l.lut(t, lambda v: v * (1 << 31) + 5, -3, 3), x)


def test_lut_by_int_fn(rng):
    """The int lane's int_fn path (the reciprocal over row sums) against
    the reference's jnp int_fn, and against the table it stands for."""
    x = rng.integers(-5, 3000, (3, 11))
    fb = 6
    fn = lambda v: (1 << (2 * fb)) // np.maximum(v, 1)   # noqa: E731
    rl, pl = _lanes("int")
    ro = rl.lut(rl.array(x), fn, 0, 2048,
                int_fn=lambda v: (1 << (2 * fb)) // jnp.maximum(v, 1))
    po = pl.lut(pl.array(x), fn, 0, 2048,
                int_fn=lambda v: (1 << (2 * fb)) // torch.clamp_min(v, 1))
    out = _check("int", rl, pl, ro, po)
    np.testing.assert_array_equal(
        out, pl.to_numpy(pl.lut(pl.array(x), fn, 0, 2048)))


@pytest.mark.parametrize("name", LANES)
def test_lut2_packed(rng, name):
    x = rng.integers(-140, 140, (2, 3, 16))
    e = rng.integers(-2, 18, (2, 3, 1))

    def fn(l, a, b):
        return l.lut2(
            a, b, lambda t, s: np.clip(np.round(t * 2.0 ** (3 - s / 2.0)),
                                       -127, 127).astype(np.int64),
            x_lo=-127, x_hi=127, y_lo=0, y_hi=15,
            float_fn=lambda t, s: torch.clamp(t * 2.0 ** (3 - s / 2.0),
                                              -127.0, 127.0)
            if isinstance(t, torch.Tensor) else
            jnp.clip(t * 2.0 ** (3 - s / 2.0), -127.0, 127.0))

    _run(name, fn, x, e)


@pytest.mark.parametrize("mask_kind", ["numpy", "torch"])
@pytest.mark.parametrize("name", LANES)
def test_select(rng, name, mask_kind):
    x = rng.integers(-50, 50, (2, 5, 6))
    m = rng.random((1, 5, 6)) > 0.4

    def fn(l, t):
        mask = (torch.from_numpy(m) if mask_kind == "torch"
                and isinstance(t, torch.Tensor) else m)
        return l.select(mask, t, -3)

    _run(name, fn, x)


@pytest.mark.parametrize("name", LANES)
def test_masked_max_with_a_fully_masked_row(rng, name):
    s = rng.integers(-5000, 5000, (2, 4, 7))
    m = rng.random((1, 4, 7)) > 0.5
    m[0, 2, :] = False                       # row 2 sees nothing
    m[0, 0, 0] = True
    out = _run(name, lambda l, t: l.masked_max(t, m, axis=-1,
                                               keepdims=True), s)
    assert np.all(out[:, 2] == jl._MASKED_ROW)


@pytest.mark.parametrize("name", LANES)
def test_matmul_plain(rng, name):
    x = rng.integers(-127, 128, (2, 3, 16))
    w = rng.integers(-127, 128, (16, 5))
    _run(name, lambda l, t: l.matmul_plain(t, w), x)


def test_int_matmul_plain_wraps_like_int32(rng):
    """An int32 product past 2^31 wraps modulo 2^32 on both int lanes."""
    x = np.full((2, 8), 60000) * rng.choice([-1, 1], (2, 8))
    w = np.full((8, 3), 30000)
    out = _run("int", lambda l, t: l.matmul_plain(t, w), x)
    exact = x @ w
    assert np.any(np.abs(exact) >= 1 << 31)
    np.testing.assert_array_equal(out, exact.astype(np.int32))


@pytest.mark.parametrize("contraction", ["dot_scores", "mix_values"])
@pytest.mark.parametrize("name", LANES)
def test_cipher_contractions(rng, name, contraction):
    a = rng.integers(-30, 30, (2, 3, 5, 8))
    b = rng.integers(-30, 30, (2, 3, 8 if contraction == "mix_values"
                               else 6, 8 if contraction == "dot_scores"
                               else 4))
    _run(name, lambda l, p, q: getattr(l, contraction)(p, q), a, b)


@pytest.mark.parametrize("contraction", ["dot_scores", "mix_values"])
def test_int_cipher_contractions_wrap_like_int32(contraction):
    a = np.full((1, 2, 3, 4), 40000)
    b = np.full((1, 2, 4, 4), 30000)
    if contraction == "dot_scores":
        out = _run("int", lambda l, p, q: l.dot_scores(p, q), a, b)
        exact = a @ b.swapaxes(-1, -2)
    else:
        out = _run("int", lambda l, p, q: l.mix_values(p, q), a, b)
        exact = a @ b
    assert np.all(np.abs(exact) >= 1 << 31)
    np.testing.assert_array_equal(out, exact.astype(np.int32))


def test_int_mul_wraps_like_int32():
    a = np.array([[70000, -70000, 3]])
    _run("int", lambda l, p, q: l.mul(p, q), a, a)


@pytest.mark.parametrize("n_max,count", [(1, None), (7, None), (300, None),
                                         (600, 5), (512, "array")])
def test_reciprocal_literal(n_max, count, rng):
    if count == "array":
        count = rng.integers(1, 512, (3, 4))
    ref = jl.reciprocal_literal(n_max, count=count)
    port = tl.reciprocal_literal(n_max, count=count)
    np.testing.assert_array_equal(np.asarray(port[0]), np.asarray(ref[0]))
    assert port[1] == ref[1]
    if isinstance(count, np.ndarray):
        lit, f = tl.reciprocal_literal(n_max, count=torch.from_numpy(count))
        np.testing.assert_array_equal(lit.numpy(), np.asarray(ref[0]))


# ---------------------------------------------------------------------------
# exact_int_matmul: the float64 branch (the card's) on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shapes", [((3, 16), (16, 5)),
                                    ((2, 4, 6, 32), (2, 4, 32, 6)),
                                    ((1, 0), (0, 3))])
def test_exact_int_matmul_float64_branch_matches_int64(rng, shapes):
    a = torch.from_numpy(rng.integers(-(1 << 20), 1 << 20, shapes[0]))
    b = torch.from_numpy(rng.integers(-(1 << 20), 1 << 20, shapes[1]))
    tl.reset_matmul_bound()
    got = tl._float64_matmul(a, b)
    want = tl.exact_int_matmul(a, b)            # the CPU's int64 branch
    assert got.dtype == want.dtype == torch.int64
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    stat = tl.matmul_bound()
    assert stat["calls"] == 1
    assert stat["max_bound"] == (
        tl._abs_max(a) * tl._abs_max(b) * a.shape[-1])
    assert stat["max_bound"] < 1 << 53


def test_exact_int_matmul_guard_refuses_inexact_products():
    a = torch.full((2, 64), 1 << 23, dtype=torch.int64)
    b = torch.full((64, 2), -(1 << 24), dtype=torch.int64)
    with pytest.raises(ValueError, match="2\\^53"):
        tl._float64_matmul(a, b)
    # just under the bound it runs, and is exact
    a = torch.full((1, 2), (1 << 26) - 1, dtype=torch.int64)
    b = torch.full((2, 1), 1 << 26, dtype=torch.int64)
    assert int(tl._float64_matmul(a, b)) == 2 * ((1 << 26) - 1) * (1 << 26)


# ---------------------------------------------------------------------------
# Lane factory
# ---------------------------------------------------------------------------

def test_get_lane_devices_and_refusals():
    assert tl.available_lanes() == ("fhe_sim", "float", "int")
    # the static analyzer's lane: on the host, whatever the default device
    from repro_torch.analysis import IntervalLane
    assert isinstance(tl.get_lane("interval"), IntervalLane)
    assert tl.get_lane("interval").ctx.device.type == "cpu"
    with pytest.raises(ValueError, match="unknown lane"):
        tl.get_lane("concrete")
    for name in tl.available_lanes():
        lane = tl.get_lane(name, device="cpu")
        assert lane.device.type == "cpu"
        if torch.cuda.is_available():
            assert tl.get_lane(name).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tl.get_lane(name)
    ctx = tsim.FheContext(device="cpu")
    assert tl.get_lane("fhe_sim", ctx=ctx).ctx is ctx


# ---------------------------------------------------------------------------
# FheContext / EncTensor counts
# ---------------------------------------------------------------------------

def test_enc_tensor_counts_and_values_match_reference(rng):
    a = rng.integers(-100, 100, (5, 6))
    b = rng.integers(-100, 100, (5, 6))
    outs = []
    for mod, ctx in ((jsim, None), (tsim, tsim.FheContext(device="cpu"))):
        ea, ctx = mod.encrypt(a, ctx)
        eb, _ = mod.encrypt(b, ctx)
        with ctx.scope("levelled"):
            x = (ea + eb) - 3
            x = x.mul_literal(np.arange(6)).shift_right(2)
            s = x.sum(axis=0)
            t = (-x).sum()
        with ctx.scope("pbs"):
            y = ea.relu() + eb.abs() + ea.sign()
            p = ea.mul_cipher(eb)
            r = ea[1:3].reshape(12)
        outs.append(([mod.decrypt(v) for v in (x, s, t, y, p, r)],
                     ctx.summary(), ctx.scope_report()))
    (rv, rs, rr), (pv, ps, pr) = outs
    for want, got in zip(rv, pv):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pv[4], a * b)
    assert ps == rs and pr == rr
    assert ps["cmuls"] == 30 and ps["pbs"] == 3 * 30 + 2 * 30


def test_fhe_context_tracks_widths_like_reference():
    for vals in ([0], [1], [-1], [127], [-128], [1 << 20], []):
        ref, port = jsim.FheContext(), tsim.FheContext(device="cpu")
        ref.count_pbs(np.asarray(vals, np.int64))
        port.count_pbs(torch.tensor(vals, dtype=torch.int64))
        ref.count_add(np.asarray(vals, np.int64) * 3, n=5)
        port.count_add(torch.tensor(vals, dtype=torch.int64) * 3, n=5)
        assert port.summary() == ref.summary(), vals
