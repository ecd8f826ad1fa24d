"""The port's sharded train step (repro_torch.launch.shardings, DTensor
over spawned gloo ranks) against the JAX package's single-device
``jax.jit(make_train_step)`` from the same parameters, on the reduced
dense config of tests/test_distributed.py: meshes (2, 2, 2) ("pod",
"data", "model"), (4, 1) and (1, 4) ("data", "model"), 2 steps each, and
2 microbatches on (2, 2) (the batch as it is: its ranks' counts of valid
labels differ).  Tolerances and AdamW's eps: see
tests/test_torch_sharded_ref.py.

Also: each rank's local shards of a parameter, its first moment and the
batch equal the reference's layout (the slices its ``param_spec`` /
``batch_spec`` name for the rank's mesh coordinate); a DTensor handed to
a kernel wrapper raises ``TypeError`` instead of computing on one shard.
"""

import numpy as np
import pytest
from jax.sharding import AbstractMesh

import test_torch_dist_ranks as torch_dist_ranks
import test_torch_sharded_ref as ref
from repro.distributed import sharding as jsh

MESHES = {
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
    "4x1": ((4, 1), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
}
ARCH = "smollm-135m"


@pytest.fixture(scope="module")
def batch():
    from repro_torch.configs import get_config

    return ref.make_batch(get_config(ARCH).reduced(**ref.DENSE))


def _run(tmp_path, mesh, batch, steps=2, microbatches=1):
    shape, names = MESHES.get(mesh, ((2, 2), ("data", "model")))
    params = ref.jax_params(ARCH, tuple(sorted(ref.DENSE.items())))
    return torch_dist_ranks.run_ranks(
        int(np.prod(shape)), "sharded_train",
        (shape, names, ARCH, ref.DENSE, params, batch, steps, microbatches,
         ref.OPT), tmp_path)


_RUNS = {}


def _cached(tmp_path, mesh, batch):
    if mesh not in _RUNS:
        _RUNS[mesh] = _run(tmp_path, mesh, batch)
    return _RUNS[mesh]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_step_matches_single_device_reference(tmp_path, batch, mesh):
    ranks = _cached(tmp_path, mesh, batch)
    losses = ref.check_against_reference(ranks[0], ARCH, ref.DENSE, batch,
                                         steps=2)
    assert losses[1] < losses[0]


def test_microbatched_sharded_step_matches_reference(tmp_path, batch):
    """The batch's rows 0 and 5 leave labels out, so the microbatches'
    parts on the two batch ranks hold different counts of valid labels:
    each microbatch is normalised by its global count, as the
    reference's is."""
    ranks = _run(tmp_path, "2x2", batch, microbatches=2)
    ref.check_against_reference(ranks[0], ARCH, ref.DENSE, batch, steps=2,
                                microbatches=2)


def _slices(spec, shape, sizes, coord_of):
    """The block of a tensor of ``shape`` that the mesh coordinate owns
    under a JAX PartitionSpec (named axes major first)."""
    idx = []
    for dim, n in enumerate(shape):
        part = spec[dim] if dim < len(spec) else None
        if part is None:
            idx.append(slice(None))
            continue
        names = part if isinstance(part, tuple) else (part,)
        blocks, i = 1, 0
        for a in names:
            i = i * sizes[a] + coord_of[a]
            blocks *= sizes[a]
        step = n // blocks
        idx.append(slice(i * step, (i + 1) * step))
    return tuple(idx)


def test_local_shards_follow_the_reference_layout(tmp_path, batch):
    shape, names = MESHES["2x2x2"]
    ranks = _cached(tmp_path, "2x2x2", batch)
    sizes = dict(zip(names, shape))
    amesh = AbstractMesh(shape, names)
    table = ref.jax_params(ARCH, tuple(sorted(ref.DENSE.items())))[
        "embed"]["table"]
    pspec = jsh.param_spec(("vocab", "embed"), table.shape, amesh)
    bspec = jsh.batch_spec(amesh)
    assert tuple(pspec) == ("model", "data")
    final = ranks[0]["params"]
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.tree import tree_flatten_with_path

    paths = [p for p, _ in tree_flatten_with_path(params_from_jax(
        ref.jax_params(ARCH, tuple(sorted(ref.DENSE.items()))),
        get_config(ARCH).reduced(**ref.DENSE), device="cpu"))]
    full_table = final[paths.index(("embed", "table"))]
    full_mu = ranks[0]["mu"][paths.index(("embed", "table"))]
    seen = set()
    for r in ranks:
        coord = dict(zip(names, r["coord"]))
        sl = _slices(tuple(pspec), full_table.shape, sizes, coord)
        np.testing.assert_array_equal(r["embed_local"], full_table[sl])
        np.testing.assert_array_equal(r["mu_local"], full_mu[sl])
        bsl = _slices(tuple(bspec), batch["tokens"].shape, sizes, coord)
        np.testing.assert_array_equal(r["tokens_local"],
                                      batch["tokens"][bsl])
        seen.add((sl[0].start, sl[1].start))
    assert len(seen) == 4          # 4 distinct shards, 2 copies each


def test_dtensor_reaching_a_kernel_wrapper_raises(tmp_path):
    msgs = torch_dist_ranks.run_ranks(2, "dtensor_to_kernel", (), tmp_path)
    assert all(m is not None and "DTensor" in m for m in msgs)
