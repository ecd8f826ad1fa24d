"""Tensor-parallel compute over ``model`` in the port's sharded train step
(``launch/shardings.py::gather_params`` and the regions of
``distributed/sharding.py``), on spawned gloo ranks, against the JAX
package's single-device ``jax.jit(make_train_step)`` from the same
parameters, 2 AdamW steps (tolerances and AdamW's eps:
tests/test_torch_sharded_ref.py):

  * the reduced dense config (4 / 2 heads) on (2, 2) ("data", "model"),
    where every layer splits, under remat "full" (each block's forward,
    its regions included, runs again in the backward);
  * the same on (1, 4), where the query heads split and K / V are
    projected whole (2 kv heads do not divide over 4), each rank keeping
    the kv head its query head attends;
  * 6 / 3 heads on (1, 4), where the attention computes whole (6 heads do
    not divide over 4) and the MLP and the vocabulary split.

Each case also shows the split on every rank: which layers were handed
split, the local query heads (h/M where they split), the ``wq`` gradient
the rank computes is its shard only and equals that slice of the
one-process gradient, and the calls to the "out of the region" operator
in a forward are the ones the layer count gives (one per split attention
and MLP a layer, one for the embedding).  And the vocab-parallel NLL on 2
ranks against ``train/step.py::_TokenNLL``, value and gradient; and the
sharded prefill and serve steps against the single-device ones, 3 decode
steps, the whole KV cache after them: the reduced dense config on
(1, 4), where two ranks share each kv head, and reduced hymba-1.5b (the
hybrid family, its Mamba carries whole) on (2, 2).
"""

import numpy as np
import pytest
import torch

import test_torch_dist_ranks as torch_dist_ranks
import test_torch_sharded_ref as ref

ARCH = "smollm-135m"
LAYERS = ref.DENSE["num_layers"]
WQ = (("blocks", 0, "attn", "wq", "kernel"), 1)
REMAT = {"remat": "full"}
#: (mesh shape, config overrides, other config fields, attention split,
#: kv projected whole)
CASES = {
    "2x2-remat": ((2, 2), ref.DENSE, REMAT, True, False),
    "1x4-mixed-gqa": ((1, 4), ref.DENSE, None, True, True),
    "1x4-whole-attention": ((1, 4), dict(ref.DENSE, num_heads=6,
                                         num_kv_heads=3), None, False, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tensor_parallel_step_matches_reference_and_splits(tmp_path, case):
    from repro_torch.configs import get_config

    shape, overrides, cfg_kw, attn_split, kv_whole = CASES[case]
    batch = ref.make_batch(get_config(ARCH).reduced(**overrides))
    params = ref.jax_params(ARCH, tuple(sorted(overrides.items())),
                            tuple(sorted((cfg_kw or {}).items())))
    ranks = torch_dist_ranks.run_ranks(
        int(np.prod(shape)), "tp_train",
        (shape, ("data", "model"), ARCH, overrides, params, batch, 2,
         ref.OPT, WQ, cfg_kw), tmp_path)
    losses = ref.check_against_reference(ranks[0], ARCH, overrides, batch,
                                         steps=2, cfg_kw=cfg_kw)
    assert losses[1] < losses[0]
    m = shape[1]
    heads = overrides["num_heads"]
    for r in ranks:
        assert r["split"] == {"attn": attn_split, "kv_whole": kv_whole,
                              "ffn": True, "shared": False, "embed": True}
        assert r["q_heads"] == (heads // m if attn_split else heads)
        d = overrides["d_model"]
        assert r["probe_full_shape"] == [d, heads, overrides["head_dim"]]
        assert r["probe_shape"] == [d, r["q_heads"], overrides["head_dim"]]
        assert r["probe_err"] <= 1e-5, r["probe_err"]
        assert r["out_calls"] == LAYERS * (2 if attn_split else 1) + 1


def test_vocab_parallel_nll_matches_token_nll(tmp_path):
    from repro_torch.train.step import _TokenNLL

    rng = np.random.default_rng(3)
    logits = (3 * rng.normal(size=(2, 5, 64))).astype(np.float32)
    labels = rng.integers(0, 64, (2, 5)).astype(np.int64)
    labels[0, :3] = [0, 31, 32]            # both ends of both halves
    weights = rng.normal(size=(2, 5)).astype(np.float32)
    ranks = torch_dist_ranks.run_ranks(2, "vocab_nll",
                                       (logits, labels, weights), tmp_path)
    for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 1e-2)):
        x = torch.from_numpy(logits).to(dtype).requires_grad_(True)
        nll = _TokenNLL.apply(x, torch.from_numpy(labels))
        grad = torch.autograd.grad((nll * torch.from_numpy(weights)).sum(),
                                   x)[0].float().numpy()
        for rank, r in enumerate(ranks):
            got_nll, got_grad = r[str(dtype)]
            np.testing.assert_allclose(got_nll, nll.detach().numpy(),
                                       rtol=tol, atol=tol)
            np.testing.assert_allclose(
                got_grad, grad[..., rank * 32:(rank + 1) * 32],
                rtol=tol, atol=tol)


def test_sharded_serving_steps_split_the_kv_heads(tmp_path):
    from repro_torch.configs import get_config

    rng = np.random.default_rng(4)
    cases = []
    for shape, arch, overrides in (((1, 4), ARCH, ref.DENSE),
                                   ((2, 2), "hymba-1.5b", {})):
        v = get_config(arch).reduced(**overrides).vocab_size
        cases.append((shape, arch, overrides,
                      ref.jax_params(arch, tuple(sorted(overrides.items()))),
                      rng.integers(0, v, (4, 8)).astype(np.int32),
                      rng.integers(0, v, (3, 4, 1)).astype(np.int32)))
    for r in torch_dist_ranks.run_ranks(4, "tp_serving", (cases,),
                                        tmp_path):
        for got in r:
            want, have = got["prefill"]
            np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-5)
            for ref_logits, logits, ref_next, nxt in got["steps"]:
                np.testing.assert_allclose(logits, ref_logits, rtol=1e-5,
                                           atol=1e-5)
                np.testing.assert_array_equal(nxt, ref_next)
            for want, have in got["kv"]:
                assert np.abs(want).max() > 0
                np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(*got["length"])
