"""The port's sharded train step against the JAX package's single-device
step for the other families, reduced, 2 steps on spawned gloo ranks:
rwkv6-7b, hymba-1.5b (hybrid), seamless-m4t-large-v2 (encoder-decoder)
and llava-next-mistral-7b (vlm, its image positions ignored by the
loss, so each rank's count of valid labels differs) on (2, 2) ("data",
"model"); qwen2-moe-a2.7b at its default capacity factor over data 4,
where assignments drop, so the slots, the capacity and the auxiliary
losses must be the global batch's, and on (2, 2) under remat "full",
where its experts, its shared expert, its heads and its vocabulary split
over ``model`` and each block's forward runs again in the backward (its
global slots and regions too): each rank shows its 2 of the 4 experts,
its expert gradient only its shard (equal to that slice of the
one-process gradient), and in a forward one "out of the region" call
per attention and per MoE layer (the experts and the shared expert
reduced together) plus one for the embedding.  Tolerances and
AdamW's eps: see tests/test_torch_sharded_ref.py.
"""

import numpy as np
import pytest
import torch

import test_torch_dist_ranks as torch_dist_ranks
import test_torch_sharded_ref as ref

MOE = "qwen2-moe-a2.7b"
#: case -> (arch, mesh shape, other config fields); the mesh axes are
#: ("data", "model")
CASES = {
    "rwkv6-7b": ("rwkv6-7b", (2, 2), None),
    "hymba-1.5b": ("hymba-1.5b", (2, 2), None),
    "seamless-m4t-large-v2": ("seamless-m4t-large-v2", (2, 2), None),
    "llava-next-mistral-7b": ("llava-next-mistral-7b", (2, 2), None),
    MOE: (MOE, (4, 1), None),
    MOE + "@2x2": (MOE, (2, 2), {"remat": "full"}),
}
#: the expert stack whose gradient shows the expert split, and its dim
EXPERT_PROBE = (("blocks", 0, "moe", "wg", "kernel"), 0)


def _batch(arch):
    from repro_torch.configs import get_config

    return ref.make_batch(get_config(arch).reduced())


@pytest.mark.parametrize("arch", list(CASES))
def test_family_sharded_step_matches_single_device_reference(tmp_path,
                                                             arch):
    arch, shape, cfg_kw = CASES[arch]
    names = ("data", "model")
    batch = _batch(arch)
    params = ref.jax_params(arch, (), tuple(sorted((cfg_kw or {}).items())))
    split = arch == MOE and shape[1] > 1
    program, extra = (("tp_train", (ref.OPT, EXPERT_PROBE, cfg_kw)) if split
                      else ("sharded_train", (1, ref.OPT)))
    ranks = torch_dist_ranks.run_ranks(
        int(np.prod(shape)), program,
        (shape, names, arch, {}, params, batch, 2, *extra), tmp_path)
    ref.check_against_reference(ranks[0], arch, {}, batch, steps=2,
                                cfg_kw=cfg_kw)
    if arch == MOE:
        m = ranks[0]["metrics"][0]
        assert m["moe_lb"] > 0 and m["moe_z"] > 0
    if split:
        from repro_torch.configs import get_config

        cfg = get_config(arch).reduced()
        e, m = cfg.moe.num_experts, shape[1]
        for r in ranks:
            assert r["split"] == {"attn": True, "kv_whole": False,
                                  "ffn": True, "shared": True,
                                  "embed": True}
            assert r["experts"] == e // m
            assert r["probe_full_shape"][0] == e
            assert r["probe_shape"] == [e // m] + r["probe_full_shape"][1:]
            assert r["probe_err"] <= 1e-5, r["probe_err"]
            assert r["out_calls"] == 2 * cfg.num_layers + 1


def test_moe_batch_drops_assignments():
    """The MoE case is only a test of global slots if this batch drops
    assignments at the default capacity factor: the port's layer on the
    whole batch, recorded layer by layer."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.models.registry import get_model
    from repro_torch.nn import moe

    cfg = get_config("qwen2-moe-a2.7b").reduced()
    params = params_from_jax(ref.jax_params("qwen2-moe-a2.7b", ()), cfg,
                             device="cpu")
    batch = _batch("qwen2-moe-a2.7b")
    dropped = []
    orig = moe.apply_moe

    def recording(*a, **kw):
        out, aux = orig(*a, **kw)
        dropped.append(float(aux.dropped_fraction))
        return out, aux

    moe.apply_moe = recording
    try:
        with torch.no_grad():
            get_model(cfg).forward(params, {"tokens": torch.from_numpy(
                batch["tokens"])})
    finally:
        moe.apply_moe = orig
    assert len(dropped) == cfg.num_layers
    assert max(dropped) > 0, dropped
