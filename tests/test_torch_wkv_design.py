"""The arithmetic of the WKV kernel (``src/repro_torch/csrc/wkv6.cu``) on the
CPU: a plain-torch emulation of its order of work, held against the JAX
package's chunked kernel in interpret mode and against the port's plain
chunked form, on the same numpy inputs.  The CUDA kernel itself runs only
on a card (tests/test_torch_kernels_cuda.py, chip_smoke.py phase 9); this
file checks that the way it computes can meet the tolerance at all.

What the emulation repeats, chunk by chunk (chunks padded to 16, 32 or 64
positions, positions past the chunk or past ``t`` zero with a log-decay
of 0):

* C, the cumulative log2 of the floored decay, C[0] = 0;
* the carry operand r 2^{C[i]} and the state operand k 2^{C[L] - C[i+1]};
* the intra-chunk matrix by sub-chunks of 8: for each key sub-chunk, every
  later row by the product (r 2^{C[i] - c}) (k 2^{c - C[j+1]})^T with c =
  C at the key sub-chunk's end, both exponents clamped at 0; on the
  diagonal blocks, for each row i and j = i-1, ..., the running product
  of the floored decays between, and the bonus sum_e r u k exactly;
* every product in 3xTF32: each float32 operand split into hi + lo, hi
  its 10 leading mantissa bits and lo the rest, each cut to TF32 (the
  tensor core reads an operand's 19 leading bits), a b = a_hi b_hi +
  a_hi b_lo + a_lo b_hi.

Tolerance: outputs and the final state, each within 5e-5 max(1,
max|ref|) (chip_smoke.py's WKV_REL) of the JAX package's exact scan
(``repro.kernels.ref.wkv6_ref``), of the port's chunked form and of the
JAX chunked kernel, with the emulation on V one step late (at t = 1: V of
the other batch row) outside it.  The JAX chunked kernel forms each
exponent as a difference of cumulative log sums and rounds it at their
size: at zero decay (log w = -69 a position, sums to -2200 over 32
positions, an ulp of 2.4e-4) it lies up to 2.2 tolerances from its own
exact scan, where the emulation lies within 0.005 of one.  Against that
kernel the tolerance therefore adds the kernel's own distance from the
scan; ``test_reference_chunked_kernel_rounds_at_zero_decay`` shows that
distance.  The one-pass TF32 form (tf32(a) tf32(b), rounded to nearest
as ``cvt.rna.tf32.f32`` rounds) is held to nothing; its error is printed
by ``python tests/test_torch_wkv_design.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import wkv6_ref as jax_wkv6_scan
from repro.kernels.rwkv6 import wkv6_chunked as jax_wkv6_chunked
from repro_torch.nn.ssm import wkv6_chunked_form

FLOOR = 1e-30
SUB = 8
REL = 5e-5
# (t, chunk, head_dim): t of one position, a ragged tail inside the first
# 16-position sub-chunk, tails that cut a sub-chunk of the second or a
# later chunk
CASES = [(t, chunk, n) for t in (1, 17, 50, 70) for chunk in (16, 32)
         for n in (16, 64)]
DECAYS = ("mixed", "zero", "near_one")


def inputs(seed, b, t, h, n, decay):
    """r, k, v, u unit normal; the decay exp(-exp(2 N(0, 1))) ("mixed",
    from ~1 down to 0 in float32), 0, or exp(-exp(N(0, 1) - 6))
    ("near_one", as at rwkv6-7b's init)."""
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return rng.normal(size=shape).astype(np.float32)

    r, k, v = mk(b, t, h, n), mk(b, t, h, n), mk(b, t, h, n)
    if decay == "zero":
        w = np.zeros((b, t, h, n), np.float32)
    elif decay == "near_one":
        w = np.exp(-np.exp(mk(b, t, h, n) - 6.0)).astype(np.float32)
    else:
        w = np.exp(-np.exp(2.0 * mk(b, t, h, n))).astype(np.float32)
    return r, k, v, w, mk(h, n)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32: 10 mantissa bits, to nearest, ties away
    from zero (the sign is apart from the magnitude bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """float32 cut to TF32: the 10 leading mantissa bits, as the tensor
    core reads a TF32 operand register."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm3(a, b):
    """a @ b in 3xTF32 as the kernel splits: hi the operand cut to TF32,
    lo the exact rest, which the tensor core cuts to TF32 in turn; the
    small terms first."""
    ah, bh = tf32_trunc(a), tf32_trunc(b)
    al, bl = tf32_trunc(a - ah), tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def mm1(a, b):
    """a @ b in one TF32 pass."""
    return tf32(a) @ tf32(b)


def emulate(r, k, v, w, u, chunk, mm=mm3):
    """The kernel's order of work from a zero state; (b, t, h, n) numpy
    float32 in, (out (b, t, h, n), state (b, h, n, n)) torch float32
    out."""
    R, K, V, Wd = (torch.from_numpy(x).transpose(1, 2) for x in (r, k, v, w))
    uf = torch.from_numpy(u)
    b, h, t, n = R.shape
    lp = 16 if chunk <= 16 else 32 if chunk <= 32 else 64
    S = torch.zeros((b, h, n, n))
    out = torch.zeros((b, h, t, n))
    for t0 in range(0, t, chunk):
        valid = min(chunk, t - t0)

        def stage(X):
            Z = torch.zeros((b, h, lp, n))
            Z[:, :, :valid] = X[:, :, t0:t0 + valid]
            return Z

        rs, ks, vs, ws = stage(R), stage(K), stage(V), stage(Wd)
        lw = torch.log2(torch.clamp_min(ws, FLOOR))
        lw[:, :, valid:] = 0.0
        C = torch.cat([torch.zeros((b, h, 1, n)), torch.cumsum(lw, 2)], 2)
        Rt = rs * torch.exp2(C[:, :, :lp])
        Kt = ks * torch.exp2(torch.clamp_max(C[:, :, lp:] - C[:, :, 1:], 0))
        A = torch.zeros((b, h, lp, lp))
        wf = torch.clamp_min(ws, FLOOR)
        for J in range(lp // SUB):
            kj = slice(SUB * J, SUB * J + SUB)
            # the rows after key sub-chunk J, factorized at its end
            rows = slice(SUB * J + SUB, lp)
            c = C[:, :, SUB * J + SUB:SUB * J + SUB + 1]
            Rh = rs[:, :, rows] * torch.exp2(
                torch.clamp_max(C[:, :, rows] - c, 0))
            Kh = ks[:, :, kj] * torch.exp2(torch.clamp_max(
                c - C[:, :, SUB * J + 1:SUB * J + SUB + 1], 0))
            A[:, :, rows, kj] = mm(Rh, Kh.transpose(-1, -2))
            # the diagonal block by running products
            for i in range(SUB * J, SUB * J + SUB):
                x = rs[:, :, i]
                A[:, :, i, i] = (x * uf * ks[:, :, i]).sum(-1)
                for j in range(i - 1, SUB * J - 1, -1):
                    A[:, :, i, j] = (x * ks[:, :, j]).sum(-1)
                    x = x * wf[:, :, j]
        O = mm(Rt, S) + mm(A, vs)
        out[:, :, t0:t0 + valid] = O[:, :, :valid]
        S = (torch.exp2(C[:, :, lp])[..., None] * S
             + mm(Kt.transpose(-1, -2), vs))
    return out.transpose(1, 2), S


def references(r, k, v, w, u, chunk):
    """(out, state) of the JAX exact scan, the JAX chunked kernel in
    interpret mode and the port's plain chunked form, as numpy."""
    jin = [jnp.asarray(x) for x in (r, k, v, w, u)]
    so, ss = jax_wkv6_scan(*jin)
    jo, js = jax_wkv6_chunked(*jin, chunk=chunk, interpret=True)
    po, ps = wkv6_chunked_form(*(torch.from_numpy(x)
                                 for x in (r, k, v, w, u)), chunk=chunk)
    return {"scan": (np.asarray(so), np.asarray(ss)),
            "jax": (np.asarray(jo), np.asarray(js)),
            "port": (po.numpy(), ps.numpy())}


def err_over_tol(got, ref):
    return np.abs(got - ref).max() / (REL * max(1.0, np.abs(ref).max()))


def allowed(refs, name, i):
    """Tolerances the emulation may lie from reference ``name`` (output
    i = 0, state i = 1): 1, plus, for the JAX chunked kernel, that
    kernel's own distance from the exact scan."""
    if name != "jax":
        return 1.0
    return 1.0 + err_over_tol(refs["jax"][i], refs["scan"][i])


def late(v):
    """V one step late; at t = 1, V of the other batch row."""
    return np.roll(v, 1, axis=1 if v.shape[1] > 1 else 0)


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("t,chunk,n", CASES)
def test_kernel_arithmetic_matches_the_reference(t, chunk, n, decay):
    ops = inputs(t * 131 + chunk + n, 2, t, 2, n, decay)
    out, state = emulate(*ops, chunk)
    assert torch.isfinite(out).all() and torch.isfinite(state).all()
    refs = references(*ops, chunk)
    for name, pair in refs.items():
        for i, (got, ref) in enumerate(zip((out, state), pair)):
            assert err_over_tol(got.numpy(), ref) <= allowed(refs, name, i), (
                name, i)
    r, k, v, w, u = ops
    ctl = emulate(r, k, late(v), w, u, chunk)[0].numpy()
    for name, (ro, _) in refs.items():
        assert err_over_tol(ctl, ro) > allowed(refs, name, 0), name


def test_reference_chunked_kernel_rounds_at_zero_decay():
    """At zero decay and chunk 32 the JAX chunked kernel lies beyond the
    tolerance from its own exact scan (its exponents are differences of
    cumulative log sums near -2200); the emulation, whose exponents
    C[i] - C[j+1] take the same stored C[i] for the row and the previous
    key, and whose diagonal blocks take running products, does not."""
    ops = inputs(50 * 131 + 32 + 16, 2, 50, 2, 16, "zero")
    refs = references(*ops, 32)
    assert err_over_tol(refs["jax"][0], refs["scan"][0]) > 1.0
    assert err_over_tol(emulate(*ops, 32)[0].numpy(),
                        refs["scan"][0]) < 0.05


@pytest.mark.parametrize("decay", DECAYS)
def test_one_pass_tf32_is_further_from_the_reference(decay):
    """The split is what the accuracy needs: the one-pass form's error is
    larger than the 3xTF32 form's at the train shape's chunk."""
    ops = inputs(3, 2, 70, 2, 64, decay)
    ro, _ = references(*ops, 32)["scan"]
    three, one = emulate(*ops, 32), emulate(*ops, 32, mm=mm1)
    assert (err_over_tol(one[0].numpy(), ro)
            > err_over_tol(three[0].numpy(), ro))


def test_tf32_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -20, 3.0, -0.0])
    assert tf32(x).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                                3.0, -0.0]
    a = torch.randn(64, generator=torch.Generator().manual_seed(0))
    hi = tf32(a)
    assert ((a - hi).abs() <= hi.abs() * 2.0 ** -11).all()


if __name__ == "__main__":
    # the errors of both forms over the cases above, in units of the
    # tolerance (max over the exact scan and the port's chunked form,
    # outputs and state), and the JAX chunked kernel's from the scan
    print("t chunk n decay  3xTF32/tol  1xTF32/tol  jax_chunked/tol")
    for t, chunk, n in CASES:
        for decay in DECAYS:
            ops = inputs(t * 131 + chunk + n, 2, t, 2, n, decay)
            refs = references(*ops, chunk)
            row = []
            for mm in (mm3, mm1):
                got = emulate(*ops, chunk, mm=mm)
                row.append(max(err_over_tol(g.numpy(), x)
                               for name in ("scan", "port")
                               for g, x in zip(got, refs[name])))
            row.append(max(err_over_tol(g, x) for g, x in zip(
                refs["jax"], refs["scan"])))
            print(t, chunk, n, decay, *(f"{x:.4g}" for x in row))
