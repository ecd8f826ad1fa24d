"""The port's dry-run (repro_torch.launch.dryrun) against the JAX
package's: the cell list, a multi-pod cell end to end on a fake process
group of 512 ranks (no device), the argument bytes of a (16, 16) train
cell against the local shards the rules place, and the wire-byte
accounting against the reference's ``parse_collective_bytes`` on
synthetic HLO lines of every kind and group size."""

import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

from repro_torch.launch import dryrun as tdry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))


@pytest.fixture(scope="module")
def jdry():
    # the reference module sets XLA_FLAGS for its own process at import
    saved = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as mod
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return mod


def _cli(*args, timeout=600):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           *args], cwd=ROOT, env=ENV, capture_output=True,
                          text=True, timeout=timeout)


def test_list_equals_reference_cell_matrix(jdry):
    r = _cli("--list")
    assert r.returncode == 0, r.stderr
    want = [f"{a:28s} {s:12s}" + ("  [skip: full-attention @ 500k]"
                                  if skip else "")
            for a, s, skip in jdry.cell_matrix()]
    assert r.stdout.splitlines() == want
    assert tdry.cell_matrix() == jdry.cell_matrix()


def test_multipod_decode_cell_runs_without_a_device(jdry, tmp_path):
    r = _cli("--arch", "smollm-135m", "--shape", "decode_32k",
             "--multi-pod", "--out-dir", str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[OK] smollm-135m_decode_32k_2x16x16" in r.stdout
    rec = json.loads((tmp_path / "smollm-135m_decode_32k_2x16x16.json")
                     .read_text())
    src = open(jdry.__file__).read()
    body = src[src.index("    record = {"):src.index("    return record")]
    keys = set(re.findall(r'^        "([a-z_]+)":', body, re.M))
    assert {"arch", "memory", "cost_raw", "cost_per_chip",
            "collectives"} <= keys
    assert keys <= set(rec), keys - set(rec)
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "generated_code_bytes"}
    assert rec["ok"] and rec["chips"] == 512 and rec["mesh"] == "2x16x16"
    assert rec["kind"] == "decode" and "measured_by" in rec
    assert rec["cost_per_chip"] == rec["cost_raw"]
    assert rec["cost_raw"]["flops"] > 0
    assert rec["collectives"]["counts"]["all-gather"] > 0
    assert rec["memory"]["argument_bytes"] > 0


def test_layers_option_cuts_the_walked_depth(tmp_path):
    """``--layers 2`` walks two layers: smollm-135m's decode cell on 16×16
    all-reduces once per split MLP and once for the embedding (its 9
    heads do not divide over 16), and the record's name carries the
    cut."""
    r = _cli("--arch", "smollm-135m", "--shape", "decode_32k", "--layers",
             "2", "--out-dir", str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[OK] smollm-135m_decode_32k_16x16_L2" in r.stdout
    rec = json.loads((tmp_path / "smollm-135m_decode_32k_16x16_L2.json")
                     .read_text())
    assert rec["opts"]["layers"] == 2
    assert rec["collectives"]["counts"]["all-reduce"] == 2 + 1


def test_train_cell_argument_bytes_are_the_local_shards(tmp_path):
    """A (16, 16) train cell of a reduced smollm: the step's argument
    bytes are the local shards of the parameters, both moments, the step
    count and the batch rows, by the rules' specs."""
    code = textwrap.dedent("""
        import json, math, torch
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        import torch.distributed._tools.fake_collectives
        from repro_torch.configs import get_config
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.distributed.sharding import AbstractMesh, param_spec
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.models.registry import get_model
        from repro_torch.tree import tree_leaves

        cfg = get_config("smollm-135m").reduced()
        shape = ShapeConfig("tiny_train", 32, 64, "train")
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=256)
        mesh = make_production_mesh(device_type="cpu")
        m, _ = dryrun._lower_one(cfg, shape, mesh, {"microbatches": 1})
        dist.destroy_process_group()
        api = get_model(cfg)
        am = AbstractMesh((16, 16), ("data", "model"))
        sizes = {"data": 16, "model": 16}
        def flat(t):
            if isinstance(t, dict):
                return [x for k in sorted(t) for x in flat(t[k])]
            if isinstance(t, list):
                return [x for e in t for x in flat(e)]
            return [t]

        local = 0
        for p, ax in zip(tree_leaves(api.init(torch.Generator(),
                                              device="meta")),
                         flat(api.axes())):
            spec = param_spec(ax, tuple(p.shape), am)
            div = math.prod(sizes[a] for part in spec if part is not None
                            for a in ((part,) if isinstance(part, str)
                                      else part))
            local += p.numel() // div * 4 * 3     # param, mu, nu (float32)
        local += 4                                # the step count (int32)
        local += 2 * (64 // 16) * 32 * 4          # tokens, labels rows
        print(json.dumps({"got": m["argument_bytes"], "want": local,
                          "params": sum(p.numel() for p in tree_leaves(
                              api.init(torch.Generator(), device="meta")))}))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["got"] == out["want"], out
    # sharding took effect: far below three whole float32 copies
    assert out["got"] < out["params"] * 12 / 4


def test_split_layers_do_a_quarter_of_the_matmul_flops_at_model_4():
    """A reduced dense train cell (4 / 4 heads, d_ff 128, vocab 256: every
    layer splits over 4) on fake (1, 1) and (1, 4) ("data", "model")
    meshes, the same 8 rows on every rank: each rank of (1, 4) does
    exactly a quarter of the matmul FLOPs, forward and backward, and the
    record lists all-reduces over groups of 4 (the regions and the
    vocab-parallel NLL)."""
    code = textwrap.dedent("""
        import json
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from torch.testing._internal.distributed.fake_pg import FakeStore
        import torch.distributed._tools.fake_collectives
        from repro_torch.analysis.costmodel import MATMUL_OPS
        from repro_torch.configs import get_config
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import dryrun

        cfg = get_config("smollm-135m").reduced(num_kv_heads=4)
        shape = ShapeConfig("tiny_train", 32, 8, "train")
        out = {}
        for m in (1, 4):
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=m)
            mesh = init_device_mesh("cpu", (1, m),
                                    mesh_dim_names=("data", "model"))
            rec, _ = dryrun._lower_one(cfg, shape, mesh, {"microbatches": 1})
            dist.destroy_process_group()
            out[m] = {"matmul": rec["costs"].flops_of(MATMUL_OPS),
                      "flops": rec["costs"].flops,
                      "all_reduce_groups": sorted({
                          g for k, _, g in rec["collectives"]
                          if k == "all-reduce"}),
                      "all_reduces": sum(k == "all-reduce" for k, _, _
                                         in rec["collectives"])}
        print(json.dumps(out))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    one, four = out["1"], out["4"]
    assert one["matmul"] > 0
    assert four["matmul"] * 4 == one["matmul"], (one, four)
    assert four["flops"] < one["flops"]
    assert 4 in four["all_reduce_groups"]
    assert four["all_reduces"] > one["all_reduces"]


def test_whole_attention_splits_its_query_rows_at_model_4():
    """The same cell with 6 / 3 heads, which do not divide over 4: the
    attention is computed whole on every rank of (1, 4), but on the
    rank's s/4 query rows only (``core.attention.query_split``), so every
    matmul but the K / V projections of the whole sequence splits four
    ways (the score and value products and wq / wo with the rows, the MLP
    and the vocabulary with their shards): 4 × a rank's matmul FLOPs are
    the (1, 1) cell's plus 3 × those projections' (2 · rows · d · 3 · 16,
    forward, input and weight gradients, two a layer)."""
    code = textwrap.dedent("""
        import json
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from torch.testing._internal.distributed.fake_pg import FakeStore
        import torch.distributed._tools.fake_collectives
        from repro_torch.analysis.costmodel import MATMUL_OPS
        from repro_torch.configs import get_config
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import dryrun

        cfg = get_config("smollm-135m").reduced(num_heads=6,
                                                num_kv_heads=3)
        shape = ShapeConfig("tiny_train", 32, 8, "train")
        out = {"kv": (cfg.num_layers * 2 * 3 * 2 * 8 * 32 * cfg.d_model
                      * 3 * cfg.attention.head_dim)}
        for m in (1, 4):
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=m)
            mesh = init_device_mesh("cpu", (1, m),
                                    mesh_dim_names=("data", "model"))
            rec, _ = dryrun._lower_one(cfg, shape, mesh, {"microbatches": 1})
            dist.destroy_process_group()
            out[m] = {"matmul": rec["costs"].flops_of(MATMUL_OPS),
                      "flops": rec["costs"].flops}
        print(json.dumps(out))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    one, four, kv = out["1"], out["4"], out["kv"]
    assert 0 < kv < one["matmul"]
    assert four["matmul"] * 4 == one["matmul"] + 3 * kv, (one, four, kv)
    assert four["flops"] * 2 < one["flops"], (one, four)


KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


@pytest.mark.parametrize("g", [1, 2, 4, 16, 256])
def test_wire_bytes_equal_reference_parse(jdry, g):
    lines, records = [], []
    shapes = [("f32", (32, 64), 4), ("bf16", (128,), 2), ("s8", (7, 3), 1)]
    for i, kind in enumerate(KINDS):
        dt, dims, size = shapes[i % len(shapes)]
        n = 1
        for d in dims:
            n *= d
        groups = f"replica_groups=[{max(512 // g, 1)},{g}]<=[512]"
        lines.append(f"  %x{i} = {dt}[{','.join(map(str, dims))}]{{0}} "
                     f"{kind}(%p{i}), channel_id=1, {groups}")
        records.append((kind, n * size, g))
    want = jdry.parse_collective_bytes("\n".join(lines))
    assert tdry.collective_bytes(records) == want
    if g > 1:
        assert all(c == 1 for c in want["counts"].values())
