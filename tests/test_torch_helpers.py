"""Public helpers of ported modules, against the JAX package on the CPU:
``core.inhibitor.sliding_window_mask`` (the reference's mask exactly),
``nn.embedding.init_positional`` / ``apply_positional`` (the reference's
lookup on the converted table), and the initializer family of
``nn.init`` (``zeros``, ``ones``, ``variance_scaling``, ``lecun_normal``,
``xavier_uniform``, ``he_normal``, ``embedding_init``): the fans exactly,
and on a large draw the sample's std within 2% of the reference's draw
and its bounds those of the reference's distribution.  The draws
themselves cannot match across the two PRNGs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.inhibitor import sliding_window_mask as jax_window_mask
from repro.nn import embedding as jemb
from repro.nn import init as jinit
from repro_torch.core.inhibitor import sliding_window_mask
from repro_torch.nn import embedding as temb
from repro_torch.nn import init as tinit


@pytest.mark.parametrize("n_q,n_k,window,q_offset", [
    (8, 8, 3, 0), (1, 40, 16, 39), (5, 12, 1, 7), (6, 10, 32, 0),
    (4, 20, 8, 10)])
def test_sliding_window_mask_equals_reference(n_q, n_k, window, q_offset):
    want = np.asarray(jax_window_mask(n_q, n_k, window, q_offset=q_offset))
    got = sliding_window_mask(n_q, n_k, window, q_offset=q_offset)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_positional_table_and_lookup_equal_reference():
    jp = jemb.init_positional(jax.random.PRNGKey(0), 64, 24)
    table = np.array(jp["table"].value)
    assert jp["table"].axes == temb.positional_axes()["table"]
    positions = np.array([[0, 5, 63], [7, 7, 1]], np.int32)
    want = np.asarray(jemb.apply_positional({"table": jnp.asarray(table)},
                                            jnp.asarray(positions),
                                            compute_dtype=jnp.bfloat16)
                      .astype(jnp.float32))
    got = temb.apply_positional({"table": torch.from_numpy(table)},
                                torch.from_numpy(positions),
                                compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    ours = temb.init_positional(torch.Generator().manual_seed(0), 64, 24)
    assert ours["table"].shape == (64, 24)
    assert abs(float(ours["table"].std()) - 0.02) < 0.002


def test_constant_initializers_equal_reference():
    for name in ("zeros", "ones"):
        want = np.asarray(getattr(jinit, name)(None, (3, 4), jnp.bfloat16)
                          .astype(jnp.float32))
        got = getattr(tinit, name)(None, (3, 4), dtype=torch.bfloat16)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)


FAN_CASES = [((), (-2, -1)), ((7,), (-2, -1))] + [
    (shape, axes) for shape in [(5, 3), (3, 3, 4, 8), (2, 6, 5),
                                (4, 1, 1, 9)]
    for axes in [(-2, -1), (0, 1), (1, 0)]]


@pytest.mark.parametrize("shape,axes", FAN_CASES)
def test_fans_equal_reference(shape, axes):
    assert tinit.fans(shape, *axes) == jinit._fans(shape, *axes)


SHAPE = (8, 4, 96, 128)          # fan_in 3,072, fan_out 4,096; 393,216 draws
#: the largest |draw| in units of the requested std: a normal truncated
#: to ±2 and rescaled to that std reaches 2 / 0.8796, a uniform √3
TRUNCATED, UNIFORM = 2.0 / 0.87962566103423978, 3.0 ** 0.5
INITS = {
    "lecun_normal": (lambda m: m.lecun_normal(), TRUNCATED),
    "he_normal": (lambda m: m.he_normal(), TRUNCATED),
    "xavier_uniform": (lambda m: m.xavier_uniform(), UNIFORM),
    "fan_out_normal": (lambda m: m.variance_scaling(0.5, "fan_out",
                                                    "normal"), None),
    "fan_avg_truncated": (lambda m: m.variance_scaling(
        3.0, "fan_avg", "truncated_normal", 0, 1), TRUNCATED),
    "embedding_init": (lambda m: m.embedding_init(0.05), None),
}


@pytest.mark.parametrize("name", list(INITS))
def test_initializer_distribution_matches_reference(name):
    """The same shape drawn by each package: the sample's std within 2%
    of the reference sample's, its mean near 0; a bounded distribution's
    largest |draw| within its bound (in units of the reference sample's
    std, 1% slack) and near the reference sample's largest."""
    make, bound = INITS[name]
    want = np.asarray(make(jinit)(jax.random.PRNGKey(1), SHAPE),
                      np.float64)
    got = make(tinit)(torch.Generator().manual_seed(1), SHAPE)
    assert got.shape == SHAPE and got.dtype == torch.float32
    got = got.double().numpy()
    assert abs(got.std() / want.std() - 1) < 0.02, (got.std(), want.std())
    assert abs(got.mean()) < 0.02 * want.std()
    if bound is not None:
        lim = bound * want.std() * 1.01
        assert np.abs(want).max() <= lim and np.abs(got).max() <= lim
        assert np.abs(got).max() > 0.95 * np.abs(want).max()


def test_initializers_keep_dtype_device_and_meta():
    gen = torch.Generator().manual_seed(0)
    x = tinit.xavier_uniform()(gen, (16, 32), dtype=torch.bfloat16)
    assert x.dtype == torch.bfloat16 and x.device.type == "cpu"
    m = tinit.he_normal()(gen, (3, 3, 4, 8), device="meta")
    assert m.is_meta and m.shape == (3, 3, 4, 8)
    with pytest.raises(ValueError):
        tinit.variance_scaling(1.0, "fan_sum", "normal")(gen, (2, 2))
    with pytest.raises(ValueError):
        tinit.variance_scaling(1.0, "fan_in", "cauchy")(gen, (2, 2))
