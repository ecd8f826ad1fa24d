"""The port's sharded train step against the JAX package's single-device
step for the other families, reduced, 2 steps on spawned gloo ranks:
rwkv6-7b, hymba-1.5b (hybrid), seamless-m4t-large-v2 (encoder-decoder)
and llava-next-mistral-7b (vlm, its image positions ignored by the
loss, so each rank's count of valid labels differs) on (2, 2) ("data",
"model"); qwen2-moe-a2.7b at its default capacity factor over data 4,
where assignments drop, so the slots, the capacity and the auxiliary
losses must be the global batch's.  Tolerances and AdamW's eps: see
tests/test_torch_sharded_ref.py.
"""

import numpy as np
import pytest
import torch

import test_torch_dist_ranks as torch_dist_ranks
import test_torch_sharded_ref as ref

CASES = {
    "rwkv6-7b": ((2, 2), ("data", "model")),
    "hymba-1.5b": ((2, 2), ("data", "model")),
    "seamless-m4t-large-v2": ((2, 2), ("data", "model")),
    "llava-next-mistral-7b": ((2, 2), ("data", "model")),
    "qwen2-moe-a2.7b": ((4, 1), ("data", "model")),
}


def _batch(arch):
    from repro_torch.configs import get_config

    return ref.make_batch(get_config(arch).reduced())


@pytest.mark.parametrize("arch", list(CASES))
def test_family_sharded_step_matches_single_device_reference(tmp_path,
                                                             arch):
    shape, names = CASES[arch]
    batch = _batch(arch)
    params = ref.jax_params(arch, ())
    ranks = torch_dist_ranks.run_ranks(
        int(np.prod(shape)), "sharded_train",
        (shape, names, arch, {}, params, batch, 2, 1, ref.OPT), tmp_path)
    ref.check_against_reference(ranks[0], arch, {}, batch, steps=2)
    if arch == "qwen2-moe-a2.7b":
        m = ranks[0]["metrics"][0]
        assert m["moe_lb"] > 0 and m["moe_z"] > 0


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
