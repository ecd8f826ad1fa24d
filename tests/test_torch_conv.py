"""The port's ``nn/conv.py`` against the reference's ``repro.nn.conv``:
1-D (NWC / WIO) and 2-D (NHWC / HWIO) convolutions on the same kernels
and inputs, SAME and VALID padding, strides 1 and 2 at odd and even
lengths and kernel sizes.  JAX's SAME with a stride pads the odd element
on the high side, which the port computes itself (torch's
``padding="same"`` refuses a stride); the output lengths are
ceil(n / stride) under SAME and ceil((n - k + 1) / stride) under VALID.
The initializers draw the reference's shapes and scale (He normal:
stddev sqrt(2 / fan_in), truncated to 2 stddev), with a zero bias.

Tolerance: float32, rtol 1e-5, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import conv as jconv
from repro.nn.module import unbox
from repro_torch.nn import conv as tconv

TOL = dict(rtol=1e-5, atol=1e-5)


def _params(rng, shape, bias):
    p = {"kernel": rng.normal(size=shape).astype(np.float32)}
    if bias:
        p["bias"] = rng.normal(size=shape[-1:]).astype(np.float32)
    return p


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("n,k", [(9, 3), (10, 3), (10, 4), (11, 2)])
def test_conv1d_matches_reference(n, k, stride, padding):
    rng = np.random.default_rng(n * 10 + k)
    p = _params(rng, (k, 3, 5), bias=stride == 1)
    x = rng.normal(size=(2, n, 3)).astype(np.float32)
    want = np.asarray(jconv.apply_conv1d(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), stride=stride,
        padding=padding))
    got = tconv.apply_conv1d(_t(p), torch.from_numpy(x), stride=stride,
                             padding=padding).numpy()
    assert got.shape == want.shape
    out = -(-n // stride) if padding == "SAME" else -(-(n - k + 1) // stride)
    assert got.shape == (2, out, 5)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("stride", [(1, 1), (2, 2), (2, 1)])
@pytest.mark.parametrize("hw,kernel", [((7, 8), (3, 3)), ((8, 9), (2, 3)),
                                       ((6, 6), (4, 1))])
def test_conv2d_matches_reference(hw, kernel, stride, padding):
    rng = np.random.default_rng(sum(hw) + sum(kernel))
    p = _params(rng, kernel + (3, 4), bias=True)
    x = rng.normal(size=(2,) + hw + (3,)).astype(np.float32)
    want = np.asarray(jconv.apply_conv2d(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), stride=stride,
        padding=padding))
    got = tconv.apply_conv2d(_t(p), torch.from_numpy(x), stride=stride,
                             padding=padding).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n,k,stride,want", [
    (10, 3, 1, (1, 1)), (10, 4, 1, (1, 2)), (10, 3, 2, (0, 1)),
    (9, 3, 2, (1, 1)), (11, 2, 2, (0, 1)), (4, 5, 2, (1, 2))])
def test_same_padding_puts_the_odd_element_high(n, k, stride, want):
    assert tconv.same_padding(n, k, stride) == want
    lo, hi = want
    assert (n + lo + hi - k) // stride + 1 == -(-n // stride)


def test_init_matches_the_reference_shapes_and_scale():
    gen = torch.Generator().manual_seed(0)
    p1 = tconv.init_conv1d(gen, 16, 32, 5, device="cpu")
    p2 = tconv.init_conv2d(gen, 16, 32, (3, 3), use_bias=False, device="cpu")
    j1 = unbox(jconv.init_conv1d(jax.random.PRNGKey(0), 16, 32, 5))
    j2 = unbox(jconv.init_conv2d(jax.random.PRNGKey(0), 16, 32, (3, 3),
                                 use_bias=False))
    assert {k: tuple(v.shape) for k, v in p1.items()} == {
        k: tuple(v.shape) for k, v in j1.items()}
    assert set(p2) == set(j2) == {"kernel"}
    assert tuple(p2["kernel"].shape) == j2["kernel"].shape
    assert not p1["bias"].any()
    for p, j, fan_in in ((p1, j1, 5 * 16), (p2, j2, 9 * 16)):
        std = np.sqrt(2.0 / fan_in)
        t = p["kernel"].numpy()
        assert abs(t.std() / std - 1) < 0.1
        assert abs(np.asarray(j["kernel"]).std() / std - 1) < 0.1
        assert np.abs(t).max() <= 2 * std / 0.87962566 + 1e-6
    with pytest.raises(ValueError, match="SAME"):
        tconv.apply_conv1d(p1, torch.zeros(1, 8, 16), padding="same")
