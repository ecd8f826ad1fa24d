"""Sequence parallelism in the norm regions (the reference's ``seq_sp``)
in the port's sharded train step, on spawned gloo ranks, against the JAX
package's single-device ``jax.jit(make_train_step)`` from the same
parameters, 2 AdamW steps (tolerances and AdamW's eps:
tests/test_torch_sharded_ref.py).

Where ``model`` divides the sequence (16 positions over 2 or 4 ranks)
the residual stream, its adds and its norms lie on each rank's (b_local,
s/M, d) positions; every region is entered by an all-gather over the
sequence and a split layer leaves it by a reduce-scatter
(``distributed/sharding.py::enter_seq`` / ``region_exit``), a layer
computed whole by a slice of its output (``own_positions``):

  * the reduced dense config on (2, 2) under remat "full" (each block's
    forward, its all-gathers and reduce-scatters included, runs again in
    the backward): every layer splits, so every gather's backward is a
    reduce-scatter, and no activation is all-reduced;
  * 6 / 3 heads on (1, 4): the attention is computed whole, so each rank
    computes its own query rows over the gathered sequence's keys (its
    K / V's gather a reduce-scatter backward, its output at the rank's
    positions: no slice);
  * reduced rwkv6-7b on (2, 2): the mixers read the whole sequence (token
    shift, WKV scan) behind a gather whose backward is the rank's slice
    (the ddlerp and the receptance gate compute alike on every rank);
  * reduced hymba-1.5b on (2, 2): the attention and the Mamba branch read
    one gathered norm output; the Mamba branch's x_proj partial is the one
    activation all-reduce left (every rank needs dt, B and C whole at
    every position of its channels' scan);
  * a sequence of 17 positions on (2, 2), which does not divide over
    ``model``: the regions all-reduce as before.

Each case counts, in one forward on every rank, the all-gathers into a
region (by their backward), the reduce-scatters and slices out of one,
and the all-reduces, and records the shapes that enter and leave over
the sequence: the residual's (b_local, s/M, d).
"""

import numpy as np
import pytest

import test_torch_dist_ranks as torch_dist_ranks
import test_torch_sharded_ref as ref

DENSE = ("smollm-135m", ref.DENSE)
#: case -> (arch, overrides, mesh shape, other config fields, sequence
#: length, region operators of a forward, the residual's shape)
CASES = {
    "dense-2x2-remat": (*DENSE, (2, 2), {"remat": "full"}, 16,
                        dict(enter_summed=5, enter_own=0, exit=5, own=0,
                             out_of_model=0), (4, 8, 32)),
    "dense-1x4-whole-attention": (
        "smollm-135m", dict(ref.DENSE, num_heads=6, num_kv_heads=3), (1, 4),
        None, 16, dict(enter_summed=5, enter_own=0, exit=3, own=0,
                       out_of_model=0), (8, 4, 32)),
    "rwkv-2x2": ("rwkv6-7b", {}, (2, 2), None, 16,
                 dict(enter_summed=1, enter_own=4, exit=5, own=2,
                      out_of_model=0), (4, 8, 64)),
    "hymba-2x2": ("hymba-1.5b", {}, (2, 2), None, 16,
                  dict(enter_summed=5, enter_own=0, exit=7, own=0,
                       out_of_model=2), (4, 8, 64)),
    "dense-2x2-seq-17-does-not-divide": (
        *DENSE, (2, 2), None, 17, dict(enter_summed=0, enter_own=0, exit=0,
                                       own=0, out_of_model=5), None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sequence_parallel_step_matches_reference(tmp_path, case):
    from repro_torch.configs import get_config

    arch, overrides, shape, cfg_kw, seq, want, residual = CASES[case]
    batch = ref.make_batch(get_config(arch).reduced(**overrides), seq=seq)
    assert batch["tokens"].shape[1] == seq
    params = ref.jax_params(arch, tuple(sorted(overrides.items())),
                            tuple(sorted((cfg_kw or {}).items())))
    ranks = torch_dist_ranks.run_ranks(
        int(np.prod(shape)), "tp_probe",
        (shape, ("data", "model"), arch, overrides, params, batch, 2,
         ref.OPT, {}, cfg_kw), tmp_path)
    losses = ref.check_against_reference(ranks[0], arch, overrides, batch,
                                         steps=2, cfg_kw=cfg_kw)
    assert losses[1] < losses[0]
    for r in ranks:
        got = r["regions"]
        assert {k: got[k] for k in want} == want, got
        assert got["seq_shapes"] == ([] if residual is None
                                     else [tuple(residual)]), got
