"""Multi-pod dry-run: trace one step of every (arch × shape × mesh) cell
on the production meshes, with no device.

Port of :mod:`repro.launch.dryrun`.  For each cell this module:
  1. starts a ``fake`` process group (``FakeStore``) of 256 ranks (the
     16×16 single-pod mesh) or 512 (2×16×16 multi-pod) in this process,
     which plays rank 0, and builds the production mesh over it;
  2. builds the parameters, AdamW state, batch and decode states as fake
     tensors (``FakeTensorMode``: shapes only, no storage) and places them
     with :mod:`repro_torch.launch.shardings` (DTensor);
  3. runs the sharded train / prefill / decode step once, every
     collective answered by ``fake_collectives``;
  4. records, under the reference's record keys: the collectives by kind
     and group size with the reference's ring wire factors
     (:func:`wire_bytes`), the per-rank FLOPs and bytes from
     :mod:`repro_torch.analysis.costmodel`'s walker, the argument bytes of
     the local shards, and the peak of the step's own allocations from
     ``torch.distributed._tools.mem_tracker.MemTracker``, as a JSON file
     under ``experiments/dryrun/``.

What each number is measured by is in the record's ``measured_by``.  The
CUDA kernels launch through ctypes and cannot run on fake storage, so the
walk plans the plain backends (the platform of fake CPU tensors is
``cpu``).  The port's step is a Python loop over every layer, so the
walk charges every layer: ``cost_per_chip`` equals ``cost_raw``, with no
depth-1 / depth-2 extrapolation (the reference extrapolates because XLA's
cost analysis counts a scan body once).  Nothing is compiled:
``compile_s`` is 0 and ``generated_code_bytes`` null.  The sharded step
runs on the rank's batch rows and computes tensor-parallel over
``model`` wherever a layer's placements put its heads, hidden width,
vocabulary rows or experts there (:func:`repro_torch.launch.shardings.
gather_params`), so the per-rank FLOPs are the local rows over the
rank's share of those layers (the RWKV-6 time-mix's h/M heads, the
channel-mix's and the Mamba block's d_ff/M and c/M channels among
them), and the record lists the regions' all-reduces over the ``model``
groups.  The layers that compute whole on every ``model`` rank are
charged whole: the channel-mix's ``receptance`` gate and any dim that
does not divide over ``model``; so is an attention whose heads per rank
do not fall into whole kv groups (smollm-135m's 9 / 3 heads, hymba-1.5b's
25 / 5 on 16) where the sequence does not divide.  Where ``model``
divides the sequence (the train and prefill cells) the norm regions are
sequence-parallel, and the record lists the all-gathers that enter the
regions and the reduce-scatters that leave them where an all-reduce left
them before; such an attention is then charged at the rank's s/M query
rows (its score and value products and its ``wq`` / ``wo`` products; ``wk``
/ ``wv`` project the whole gathered sequence), and the record lists the
all-reduces that sum its weights' gradients over ``model``.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  python -m repro_torch.launch.dryrun --arch rwkv6-7b --shape train_4k \
      --layers 2 --microbatches 1
  python -m repro_torch.launch.dryrun --all [--multi-pod-all]
  python -m repro_torch.launch.dryrun --list
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

#: elementwise operations charged as transcendentals (one per element)
_TRANSCENDENTAL = frozenset({
    "exp", "exp2", "expm1", "log", "log1p", "log2", "tanh", "sigmoid",
    "rsqrt", "sqrt", "erf", "erfinv", "silu", "gelu", "sin", "cos",
    "logsumexp", "_softmax", "_log_softmax"})


def wire_bytes(kind: str, r_bytes: float, g: int) -> float:
    """Per-rank wire bytes of one collective whose per-rank RESULT is
    ``r_bytes``, in a group of ``g``, by the reference's ring factors:
      all-gather         r·(g−1)/g      (receives everyone else's shard)
      all-reduce         2·r·(g−1)/g    (reduce-scatter + all-gather)
      reduce-scatter     r·(g−1)        (result r is the scattered shard)
      all-to-all         r·(g−1)/g
      collective-permute r              (one hop)"""
    if kind == "all-gather":
        return r_bytes * (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * r_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return float(r_bytes) * (g - 1)
    if kind == "all-to-all":
        return r_bytes * (g - 1) / g
    return float(r_bytes)


def collective_bytes(records) -> dict:
    """``records``: (kind, result bytes, group size) per collective.
    Returns the reference's ``parse_collective_bytes`` dict; a group of
    one moves nothing and is not counted."""
    per_kind = {k: 0.0 for k in COLLECTIVE_OPS}
    counts = {k: 0 for k in COLLECTIVE_OPS}
    for kind, r_bytes, g in records:
        if g <= 1:
            continue
        per_kind[kind] += wire_bytes(kind, r_bytes, g)
        counts[kind] += 1
    total = sum(per_kind.values())
    return {"per_kind_bytes": {k: int(v) for k, v in per_kind.items()},
            "counts": counts, "total_bytes_per_chip": int(total)}


def _nbytes(x) -> int:
    import torch

    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def _group_size(group) -> int:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    if isinstance(group, str):
        return _resolve_process_group(group).size()
    if not isinstance(group, dist.ProcessGroup):
        group = dist.ProcessGroup.unbox(group)    # the op's boxed argument
    return group.size()


def _collective(func, args, out):
    """(kind, per-rank result bytes, group size) of a collective op, or
    None."""
    name = func.__name__.split(".")[0]
    ns = func.namespace
    if ns in ("_c10d_functional", "_c10d_functional_autograd"):
        if name.startswith("all_gather_into_tensor"):
            return "all-gather", _nbytes(out), int(args[1])
        if name.startswith("reduce_scatter_tensor"):
            return "reduce-scatter", _nbytes(out), int(args[2])
        if name.startswith("all_reduce"):
            return "all-reduce", _nbytes(out), _group_size(args[-1])
        if name.startswith("all_to_all_single"):
            return "all-to-all", _nbytes(out), _group_size(args[-1])
        return None
    if ns == "c10d":
        if name == "allreduce_":
            return "all-reduce", _nbytes(args[0]), _group_size(args[1])
        if name in ("allgather_", "_allgather_base_"):
            return "all-gather", _nbytes(args[0]), _group_size(args[2])
        if name in ("reduce_scatter_", "_reduce_scatter_base_"):
            return "reduce-scatter", _nbytes(args[0]), _group_size(args[2])
        if name == "send":
            return "collective-permute", _nbytes(args[0]), 2
    return None


def _recorder():
    from repro_torch.analysis.costmodel import CostMode

    class Recorder(CostMode):
        """The cost walker, also keeping each collective and counting the
        transcendental elements."""

        def __init__(self):
            super().__init__()
            self.collectives = []
            self.transcendentals = 0.0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            rec = _collective(func, args, out)
            if rec is not None:
                self.collectives.append(rec)
            elif func.__name__.split(".")[0] in _TRANSCENDENTAL:
                self.transcendentals += sum(
                    t.numel() for t in ([out] if hasattr(out, "numel")
                                        else []))
            return out

    return Recorder()


def _fake_like(meta_tree):
    import torch

    from repro_torch.tree import tree_map

    return tree_map(lambda m: None if m is None else
                    torch.zeros(m.shape, dtype=m.dtype), meta_tree)


def _local_bytes(tree) -> int:
    from repro_torch.launch.shardings import local
    from repro_torch.tree import tree_leaves

    return sum(_nbytes(local(x)) for x in tree_leaves(tree) if x is not None)


def _lower_one(cfg, shape, mesh, opts):
    """Trace one step of the cell on fake tensors.  Returns the
    measurements and (trace seconds, 0.0)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch import shardings as shlib
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import box_like
    from repro_torch.optim.adamw import AdamWConfig, init_adamw

    api = get_model(cfg)
    t0 = time.time()
    meta = api.init(torch.Generator(), device="meta")
    with FakeTensorMode(allow_non_fake_inputs=True), \
            use_mesh(mesh, act_rules=opts.get("act_rules")):
        params = _fake_like(meta)
        _, psh = shlib.params_shardings(box_like(params, api.axes()), mesh)
        dparams = shlib.place(params, psh,
                              requires_grad=shape.kind == "train")
        specs = api.input_specs(shape)
        if shape.kind == "train":
            opt_cfg = AdamWConfig()
            opt = init_adamw(params, opt_cfg)
            dopt = shlib.place(opt, shlib.opt_shardings(opt, psh, mesh))
            batch = _fake_like(specs)
            dbatch = shlib.place(batch, shlib.batch_shardings(batch, mesh))
            step = shlib.make_sharded_train_step(
                api, opt_cfg, mesh, microbatches=opts.get("microbatches", 1))
            args = (dparams, dopt, dbatch)
        elif shape.kind == "prefill":
            batch = _fake_like(specs)
            dbatch = shlib.place(batch, shlib.batch_shardings(batch, mesh))
            step = shlib.make_sharded_prefill_step(api, mesh)
            args = (dparams, dbatch)
        else:  # decode
            states = api.init_states(shape.global_batch, shape.seq_len,
                                     device="cpu")
            dstates = shlib.place(states, shlib.state_shardings(
                states, mesh, shape.global_batch))
            batch = _fake_like(specs)
            tokens = batch.pop("tokens")
            dtokens = shlib.place(tokens, shlib.batch_shardings(
                {"tokens": tokens}, mesh)["tokens"])
            dextra = (shlib.place(batch, shlib.batch_shardings(batch, mesh))
                      if batch else None)
            step = shlib.make_sharded_serve_step(api, mesh)
            args = (dparams, dtokens, dstates, dextra)
        arg_bytes = sum(_local_bytes(a) for a in args if a is not None)
        del params, meta
        tracker = MemTracker()
        rec = _recorder()
        with tracker, rec:
            out = step(*args)
        peak = max(v["Total"] for v in
                   tracker.get_tracker_snapshot("peak").values())
        out_bytes = _local_bytes(out[:2] if shape.kind == "train" else out)
    t_lower = time.time() - t0
    return {"costs": rec.costs, "collectives": rec.collectives,
            "transcendentals": rec.transcendentals,
            "argument_bytes": arg_bytes, "output_bytes": out_bytes,
            "temp_bytes": peak}, (t_lower, 0.0)


def _mech_name(cfg):
    from repro_torch.core.mechanism import resolve_mechanism_name

    return resolve_mechanism_name(cfg.attention)


MEASURED_BY = {
    "memory.argument_bytes": "the local shards of the step's inputs "
                             "(DTensor placements)",
    "memory.output_bytes": "the local shards of the step's outputs (the "
                           "train step's params and optimizer state)",
    "memory.temp_bytes": "torch.distributed._tools.mem_tracker.MemTracker: "
                         "peak of the step's own allocations (fake tensors)",
    "cost": "repro_torch.analysis.costmodel walker (aten ops on fake "
            "tensors, plain backends; every layer walked, no "
            "extrapolation)",
    "collectives": "the step's c10d / functional collectives on the fake "
                   "process group, ring wire factors",
    "compile": "nothing is compiled",
}


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               attention_kind=None, *, opts=None):
    """Trace one cell in this process.  Returns the record dict."""
    import dataclasses

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import SHAPES_BY_NAME, get_config
    from repro_torch.launch.mesh import make_production_mesh

    # registers the fake collectives' implementations
    import torch.distributed._tools.fake_collectives  # noqa: F401

    opts = opts or {}
    cfg = get_config(arch if attention_kind is None
                     else f"{arch}@{attention_kind}")
    if opts.get("remat"):
        cfg = dataclasses.replace(cfg, remat=opts["remat"])
    if opts.get("layers"):
        cfg = cfg.with_layers(opts["layers"])
    shape = SHAPES_BY_NAME[shape_name]
    chips = 512 if multi_pod else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=chips)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        m, (t_lower, t_compile) = _lower_one(cfg, shape, mesh, opts)
    finally:
        dist.destroy_process_group()
    coll = collective_bytes(m["collectives"])
    cost = {"flops": m["costs"].flops,
            "bytes accessed": m["costs"].hbm_bytes,
            "transcendentals": m["transcendentals"],
            "collective_bytes": float(coll["total_bytes_per_chip"])}
    return {
        "arch": arch,
        "attention_kind": attention_kind or _mech_name(cfg),
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips,
        "kind": shape.kind,
        "ok": True,
        "lower_s": round(t_lower, 1),
        "compile_s": round(t_compile, 1),
        "memory": {
            "argument_bytes": int(m["argument_bytes"]),
            "output_bytes": int(m["output_bytes"]),
            "temp_bytes": int(m["temp_bytes"]),
            "generated_code_bytes": None,
        },
        "cost_raw": cost,
        "cost_per_chip": dict(cost),
        "collectives": coll,
        "opts": opts,
        "measured_by": MEASURED_BY,
    }


def _tag(arch, shape_name, multi_pod, attention_kind, opts) -> str:
    return (f"{arch}_{shape_name}_{'2x16x16' if multi_pod else '16x16'}"
            + (f"_{attention_kind}" if attention_kind else "")
            + (f"_L{opts['layers']}" if opts and opts.get("layers") else "")
            + (f"_{opts['tag']}" if opts and opts.get("tag") else ""))


def run_cell(arch, shape_name, multi_pod, attention_kind=None, opts=None,
             out_dir="experiments/dryrun"):
    os.makedirs(out_dir, exist_ok=True)
    tag = _tag(arch, shape_name, multi_pod, attention_kind, opts)
    try:
        rec = build_cell(arch, shape_name, multi_pod, attention_kind,
                         opts=opts)
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec = {"arch": arch, "shape": shape_name,
               "mesh": "2x16x16" if multi_pod else "16x16",
               "attention_kind": attention_kind, "ok": False,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    path = os.path.join(out_dir, tag + ".json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    status = "OK" if rec.get("ok") else "FAIL"
    mem = rec.get("memory", {}).get("temp_bytes")
    print(f"[{status}] {tag}  temp={mem/1e9:.2f}GB" if mem else
          f"[{status}] {tag}", flush=True)
    if not rec.get("ok"):
        print("   ", rec.get("error"), flush=True)
    return rec


def cell_matrix():
    """The assigned 40 cells (+ noted skips), as the reference lists them."""
    from repro_torch.configs import ARCH_IDS, LONG_CONTEXT_ARCHS
    from repro_torch.configs.base import SHAPES

    cells = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            skip = (shape.name == "long_500k"
                    and arch not in LONG_CONTEXT_ARCHS)
            cells.append((arch, shape.name, skip))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--attention", default=None,
                    help="override attention kind (inhibitor|dotprod|...)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run the full single-pod baseline matrix")
    ap.add_argument("--multi-pod-all", action="store_true",
                    help="also run every cell on the 2x16x16 mesh")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out-dir", default="experiments/dryrun")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--tag", default=None)
    ap.add_argument("--microbatches", type=int, default=4,
                    help="gradient-accumulation microbatches (train shapes)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this depth (the walk charges "
                    "every layer; the eager scans of rwkv6-7b and "
                    "hymba-1.5b at full depth take hours on fake tensors)")
    args = ap.parse_args(argv)

    if args.list:
        for arch, shape, skip in cell_matrix():
            print(f"{arch:28s} {shape:12s}"
                  + ("  [skip: full-attention @ 500k]" if skip else ""))
        return 0

    opts = {"microbatches": args.microbatches}
    if args.remat:
        opts["remat"] = args.remat
    if args.tag:
        opts["tag"] = args.tag
    if args.layers:
        opts["layers"] = args.layers

    if args.all or args.multi_pod_all:
        import subprocess
        failures = 0
        for arch, shape, skip in cell_matrix():
            if skip:
                print(f"[SKIP] {arch}_{shape} (full-attention @ 500k)",
                      flush=True)
                continue
            meshes = [False] if args.all and not args.multi_pod_all else []
            if args.multi_pod_all:
                meshes = [False, True] if args.all else [True]
            for mp in meshes:
                # one subprocess per cell: each starts its own fake group
                # and isolates a single cell's crash from the matrix
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape,
                       "--out-dir", args.out_dir,
                       "--microbatches", str(args.microbatches)]
                if mp:
                    cmd.append("--multi-pod")
                if args.attention:
                    cmd += ["--attention", args.attention]
                if args.remat:
                    cmd += ["--remat", args.remat]
                if args.tag:
                    cmd += ["--tag", args.tag]
                if args.layers:
                    cmd += ["--layers", str(args.layers)]
                r = subprocess.run(cmd, timeout=3600)
                failures += 0 if r.returncode == 0 else 1
        print(f"done; {failures} failures", flush=True)
        return 1 if failures else 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all, or --list)")
    rec = run_cell(args.arch, args.shape, args.multi_pod, args.attention,
                   opts or None, args.out_dir)
    return 0 if rec.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
