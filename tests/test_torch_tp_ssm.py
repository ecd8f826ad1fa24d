"""The RWKV-6 mixers and the Mamba branch tensor-parallel over ``model``
in the port's sharded steps (``launch/shardings.py::gather_params``,
``nn/ssm.py``), on spawned gloo ranks, against the JAX package's
single-device ``jax.jit(make_train_step)`` from the same parameters, 2
AdamW steps (tolerances and AdamW's eps: tests/test_torch_sharded_ref.py),
on batches of 17 positions, so that every region all-reduces (the
sequence-parallel regions over the same layers: tests/test_torch_sp.py):

  * reduced rwkv6-7b (4 heads of 16) on (2, 2) and on (1, 4): the
    time-mix computes the rank's h/M heads, the channel-mix its slice of
    the hidden width (its ``receptance`` gathered whole);
  * an RWKV config whose 6 heads do not divide over 4 (d 96) on (1, 4):
    the time-mix computes whole (its projections are stored sharded, but
    a shard of 24 columns is not whole heads), the channel-mix splits;
  * reduced hymba-1.5b on (2, 2), where the attention and the Mamba
    branch both split, and with 6 / 3 heads on (1, 4), where the
    attention computes whole and the Mamba branch splits.

Each case shows on every rank: the layers of the first block handed
split and the entries they hold whole, the local heads or channels, the
gradients of the split projections (``receptance``, ``conv_w``, ...)
equal to the matching slice of the one-process gradient, those of the
leaves held whole (``in_proj``, ``u``, ``w_base``, ``ln_x``, ...) whole,
equal to the one-process gradient and the same on every rank, and the
region exits of one forward.  And the sharded serve step of both
families on (2, 2), 3 decode steps against the single-device step: the
tokens, the logits, and the whole WKV state and Mamba carries after them
(each leaf within 1e-5 of its largest |value|).
"""

import numpy as np
import pytest

import test_torch_dist_ranks as torch_dist_ranks
import test_torch_sharded_ref as ref

RWKV, HYMBA = "rwkv6-7b", "hymba-1.5b"
TM_WHOLE = ["ln_x", "mix_lora_a", "mix_lora_b", "mu_base", "u", "w_base",
            "w_lora_a", "w_lora_b"]
CM_WHOLE = ["mu_k", "mu_r", "receptance"]
MAMBA_WHOLE = ["in_proj"]


def _tm(leaf, *rest):
    return ("blocks", 0, "time_mix", leaf) + rest


RWKV_PROBES = {
    "tm_receptance": (_tm("receptance", "kernel"), 1),
    "tm_output": (_tm("output", "kernel"), 0),
    "cm_receptance": (("blocks", 0, "channel_mix", "receptance", "kernel"),
                      None),
    "cm_key": (("blocks", 0, "channel_mix", "key", "kernel"), 1),
    "u": (_tm("u"), None),
    "w_base": (_tm("w_base"), None),
    "w_lora_b": (_tm("w_lora_b"), None),
    "ln_x_scale": (_tm("ln_x", "scale"), None),
    "mu_base": (_tm("mu_base"), None),
}
MAMBA_PROBES = {
    "in_proj": (("blocks", 0, "mamba", "in_proj", "kernel"), None),
    "conv_w": (("blocks", 0, "mamba", "conv_w"), 1),
    "A_log": (("blocks", 0, "mamba", "A_log"), 0),
    "x_proj": (("blocks", 0, "mamba", "x_proj", "kernel"), 0),
    "branch_scale": (("blocks", 0, "branch_scale"), None),
}
#: the leaves each rank holds whole: their gradients must be the same on
#: every rank
WHOLE_PROBES = ("cm_receptance", "u", "w_base", "w_lora_b", "ln_x_scale",
                "mu_base", "in_proj", "branch_scale")
HEADS6 = dict(d_model=96, num_heads=6, num_kv_heads=6, head_dim=16)
#: 17 positions divide over neither 2 nor 4 ``model`` ranks: the regions
#: all-reduce (tests/test_torch_sp.py holds the sequence-parallel ones)
SEQ = 17
#: case -> (arch, mesh shape, overrides, the first block's split layers
#: and their whole entries, local heads (RWKV) or channels (Mamba), the
#: region exits of a forward)
CASES = {
    "rwkv-2x2": (RWKV, (2, 2), {}, {"time_mix": TM_WHOLE,
                                    "channel_mix": CM_WHOLE}, 2, 5),
    "rwkv-1x4": (RWKV, (1, 4), {}, {"time_mix": TM_WHOLE,
                                    "channel_mix": CM_WHOLE}, 1, 5),
    "rwkv-1x4-heads-do-not-divide": (RWKV, (1, 4), HEADS6,
                                     {"channel_mix": CM_WHOLE}, 6, 3),
    "hymba-2x2": (HYMBA, (2, 2), {}, {"attn": [], "mamba": MAMBA_WHOLE,
                                      "ffn": []}, 64, 9),
    "hymba-1x4-whole-attention": (HYMBA, (1, 4), dict(num_heads=6,
                                                      num_kv_heads=3),
                                  {"mamba": MAMBA_WHOLE, "ffn": []}, 32, 7),
}


@pytest.mark.parametrize("case", list(CASES))
def test_split_mixers_match_reference(tmp_path, case):
    from repro_torch.configs import get_config

    arch, shape, overrides, split, local, exits = CASES[case]
    cfg = get_config(arch).reduced(**overrides)
    batch = ref.make_batch(cfg, seq=SEQ)
    params = ref.jax_params(arch, tuple(sorted(overrides.items())))
    probes = RWKV_PROBES if arch == RWKV else MAMBA_PROBES
    ranks = torch_dist_ranks.run_ranks(
        int(np.prod(shape)), "tp_probe",
        (shape, ("data", "model"), arch, overrides, params, batch, 2,
         ref.OPT, probes), tmp_path)
    losses = ref.check_against_reference(ranks[0], arch, overrides, batch,
                                         steps=2)
    assert losses[1] < losses[0]
    m = shape[1]
    for r in ranks:
        assert r["split"] == split
        assert r["heads" if arch == RWKV else "channels"] == local
        assert r["regions"]["exits"] == exits, r["regions"]
        for name, got in r["probes"].items():
            assert got["err"] <= 1e-5, (name, got["err"])
            full, have = got["full_shape"], got["shape"]
            sliced = probes[name][1] is not None and (
                name not in ("tm_receptance", "tm_output")
                or "time_mix" in split)
            want = list(full)
            if sliced:
                want[probes[name][1]] //= m
            assert have == want, (name, have, full)
    for name in WHOLE_PROBES:
        if name in probes:
            grads = [r["probes"][name]["grad"] for r in ranks]
            scale = np.abs(grads[0]).max()
            assert scale > 0, name
            for g in grads[1:]:
                assert np.abs(g - grads[0]).max() <= 1e-6 * scale, name


def test_split_mixers_serve_steps_match_single_device(tmp_path):
    from repro_torch.configs import get_config

    rng = np.random.default_rng(5)
    cases = []
    for arch in (RWKV, HYMBA):
        v = get_config(arch).reduced().vocab_size
        cases.append(((2, 2), arch, {}, ref.jax_params(arch, ()),
                      rng.integers(0, v, (4, 8)).astype(np.int32),
                      rng.integers(0, v, (3, 4, 1)).astype(np.int32)))
    for r in torch_dist_ranks.run_ranks(4, "tp_serving", (cases,),
                                        tmp_path):
        for arch, got in zip((RWKV, HYMBA), r):
            want, have = got["prefill"]
            np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-5)
            for ref_logits, logits, ref_next, nxt in got["steps"]:
                np.testing.assert_allclose(logits, ref_logits, rtol=1e-5,
                                           atol=1e-5)
                np.testing.assert_array_equal(nxt, ref_next)
            names = {path for path, _, _ in got["states"]}
            assert names >= ({".wkv", ".tm_x", ".cm_x"} if arch == RWKV
                             else {".ssm", ".conv", ".kv/.k", ".kv/.v"})
            for path, want, have in got["states"]:
                # within 1e-5 of the leaf's scale: the WKV state sums
                # 11 positions' products, rounded in another order where
                # the row-parallel outputs are summed over the ranks
                scale = max(float(np.abs(want).max()), 1e-30)
                assert np.abs(have - want).max() <= 1e-5 * scale, (
                    arch, path, float(np.abs(have - want).max()), scale)
