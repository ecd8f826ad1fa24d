"""Microbatches under a mesh: the sharded train step's microbatch m is
the reference's, the global rows [m·B/M, (m+1)·B/M), each batch rank
holding its part of them (``distributed.sharding.global_microbatches``,
one all-to-all of each batch key over the batch axes).

Against the JAX package's single-device ``make_train_step(...,
microbatches=2)``, 2 steps on spawned gloo ranks (tolerances and AdamW's
eps: tests/test_torch_sharded_ref.py): reduced qwen2-moe-a2.7b on (4, 1)
("data", "model") at its default capacity factor, where a microbatch
drops assignments, so capacity, slots and auxiliary losses must be the
global microbatch's; reduced llava-next-mistral-7b on (2, 2) with its
image positions ignored by the loss, so the ranks' counts of valid
labels differ.  The rows each rank gets on (2, 2, 2) ("pod", "data",
"model", two batch axes flattened into one group) and on (4, 2), for
M = 1, 2, 4, 8 of 32 rows, and the ``ValueError`` naming B, M and R
for M = 3.  The dry-run lowers a reduced qwen2-moe train cell at its
CLI default of 4 microbatches on a fake (16, 16) mesh.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import test_torch_dist_ranks as torch_dist_ranks
import test_torch_sharded_ref as ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
MOE, VLM = "qwen2-moe-a2.7b", "llava-next-mistral-7b"
CASES = {MOE: ((4, 1), ("data", "model")),
         VLM: ((2, 2), ("data", "model"))}
ROWS, SPLITS = 32, (1, 2, 3, 4, 8)


def _batch(arch):
    from repro_torch.configs import get_config

    return ref.make_batch(get_config(arch).reduced())


@pytest.mark.parametrize("arch", list(CASES))
def test_microbatched_family_step_matches_reference(tmp_path, arch):
    shape, names = CASES[arch]
    batch = _batch(arch)
    ranks = torch_dist_ranks.run_ranks(
        int(np.prod(shape)), "sharded_train",
        (shape, names, arch, {}, ref.jax_params(arch, ()), batch, 2, 2,
         ref.OPT), tmp_path)
    ref.check_against_reference(ranks[0], arch, {}, batch, steps=2,
                                microbatches=2)
    if arch == MOE:
        m = ranks[0]["metrics"][0]
        assert m["moe_lb"] > 0 and m["moe_z"] > 0


def test_moe_microbatch_drops_assignments():
    """The MoE case tests global slots only if a microbatch of its batch
    drops assignments at the default capacity factor: the port's layer
    on each of the two global microbatches, recorded layer by layer."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.models.registry import get_model
    from repro_torch.nn import moe

    cfg = get_config(MOE).reduced()
    params = params_from_jax(ref.jax_params(MOE, ()), cfg, device="cpu")
    tokens = torch.from_numpy(_batch(MOE)["tokens"])
    dropped = []
    orig = moe.apply_moe

    def recording(*a, **kw):
        out, aux = orig(*a, **kw)
        dropped.append(float(aux.dropped_fraction))
        return out, aux

    moe.apply_moe = recording
    try:
        with torch.no_grad():
            for rows in tokens.chunk(2):
                get_model(cfg).forward(params, {"tokens": rows})
    finally:
        moe.apply_moe = orig
    assert len(dropped) == 2 * cfg.num_layers
    assert max(dropped) > 0, dropped


def test_vlm_ranks_hold_unequal_label_counts():
    """The llava case tests the global normalisation only if the batch
    ranks' parts of a microbatch hold different counts of valid labels
    (rows of 4 over (2, 2): rank r of microbatch m holds rows 4m + 2r,
    4m + 2r + 1)."""
    labels = _batch(VLM)["labels"]
    counts = [[int((labels[4 * m + 2 * r:4 * m + 2 * r + 2] >= 0).sum())
               for r in range(2)] for m in range(2)]
    assert all(a != b for a, b in counts), counts


@pytest.fixture(scope="module")
def split_rows(tmp_path_factory):
    return torch_dist_ranks.run_ranks(
        8, "microbatch_rows", (ROWS, SPLITS),
        tmp_path_factory.mktemp("mb_rows"))


@pytest.mark.parametrize("mesh", ["2x2x2", "4x2"])
@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_each_rank_holds_its_part_of_the_global_microbatch(split_rows,
                                                           mesh, m):
    b = ROWS // (m * 4)
    seen = []
    for ranks in split_rows:
        r, count = ranks[mesh]["index"]
        assert count == 4
        got = ranks[mesh]["rows"][m]
        want = [list(range(k * ROWS // m + r * b, k * ROWS // m + (r + 1) * b))
                for k in range(m)]
        assert got == want, (mesh, m, r, got)
        seen.append(r)
    assert sorted(seen) == [0, 0, 1, 1, 2, 2, 3, 3]   # model ranks copy


@pytest.mark.parametrize("mesh", ["2x2x2", "4x2"])
def test_indivisible_microbatches_raise(split_rows, mesh):
    for ranks in split_rows:
        msg = ranks[mesh]["rows"][3]
        assert isinstance(msg, str)
        assert "B = 32" in msg and "M = 3" in msg and "R = 4" in msg


def test_dryrun_lowers_a_microbatched_moe_train_cell():
    """A (16, 16) train cell of the reduced qwen2-moe at 4 microbatches
    (the dry-run CLI's default), 64 rows: each microbatch's 16 rows, one
    a data rank, reach it by one all-to-all of each batch key."""
    code = textwrap.dedent("""
        import json
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        import torch.distributed._tools.fake_collectives
        from repro_torch.configs import get_config
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_production_mesh

        cfg = get_config("qwen2-moe-a2.7b").reduced()
        shape = ShapeConfig("tiny_train", 32, 64, "train")
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=256)
        mesh = make_production_mesh(device_type="cpu")
        m, _ = dryrun._lower_one(cfg, shape, mesh, {"microbatches": 4})
        dist.destroy_process_group()
        kinds = {}
        for kind, _, g in m["collectives"]:
            kinds.setdefault(kind, set()).add(g)
        print(json.dumps({"flops": m["costs"].flops,
                          "kinds": {k: sorted(v) for k, v in kinds.items()},
                          "a2a": sum(k == "all-to-all"
                                     for k, _, _ in m["collectives"])}))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["flops"] > 0
    assert out["a2a"] == 2 and out["kinds"]["all-to-all"] == [16]
