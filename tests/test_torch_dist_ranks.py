"""Rank programs for the port's multi-rank CPU tests (gloo, spawned);
this module holds no test of its own.

No JAX here: every rank imports only ``torch`` and ``repro_torch``.  The
test processes compute the JAX reference and pass plain numpy trees in.

:func:`run_ranks` spawns ``world`` processes, each joining a gloo group
through a file under the test's ``tmp_path`` (no TCP port to collide
under xdist), runs one of the programs below, and returns the results of
every rank in rank order.  A rank that fails or hangs fails the call
within ``timeout`` seconds.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import traceback

TIMEOUT = 300


def _entry(rank, world, init_file, program, args, q):
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=world)
        try:
            out = globals()[program](rank, world, *args)
        finally:
            dist.destroy_process_group()
        q.put((rank, "ok", out))
    except BaseException:  # noqa: BLE001 — report to the parent, then exit
        q.put((rank, "error", traceback.format_exc()))


def run_ranks(world: int, program: str, args: tuple, tmp_path,
              timeout: float = TIMEOUT) -> list:
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init_file = os.path.join(str(tmp_path), f"pg_{program}_{os.getpid()}")
    procs = [ctx.Process(target=_entry, args=(r, world, init_file, program,
                                              args, q))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(world):
            rank, status, out = q.get(timeout=timeout)
            if status != "ok":
                raise AssertionError(f"rank {rank} failed:\n{out}")
            results[rank] = out
    except queue_mod.Empty:
        raise AssertionError(f"ranks did not finish in {timeout} s "
                             f"(done: {sorted(results)})")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def with_fields(cfg, cfg_kw=None):
    """``cfg`` with the fields of ``cfg_kw`` replaced; its ``"attention"``
    entry, a tuple of (field, value) pairs (hashable, for the reference's
    parameter cache), replaces fields of ``cfg.attention``.  Works on the
    port's configs and the JAX package's alike."""
    import dataclasses

    kw = dict(cfg_kw or {})
    if "attention" in kw:
        kw["attention"] = dataclasses.replace(cfg.attention,
                                              **dict(kw["attention"]))
    return dataclasses.replace(cfg, **kw) if kw else cfg


def _np(tree):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: None if t is None else
                    t.detach().float().numpy().copy()
                    if t.is_floating_point() else t.detach().numpy().copy(),
                    tree)


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------

def sharded_train(rank, world, shape, names, arch, overrides, jax_params,
                  batch, steps, microbatches, opt_kw, cfg_kw=None):
    """``steps`` sharded train steps from the converted reference
    parameters.  Every rank returns its local shards of the embedding
    table, its first moment and the tokens (the placement check); rank 0
    also the losses, metrics and the gathered parameters."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.launch import shardings as shlib
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import box_like
    from repro_torch.optim import AdamWConfig, init_adamw
    from repro_torch.tree import tree_leaves

    cfg = with_fields(get_config(arch).reduced(**overrides), cfg_kw)
    api = get_model(cfg)
    mesh = _mesh(shape, names)
    opt = AdamWConfig(**opt_kw)
    params = params_from_jax(jax_params, cfg, device="cpu")
    state = init_adamw(params, opt)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, psh = shlib.params_shardings(box_like(params, api.axes()), mesh)
    dp = shlib.place(params, psh, requires_grad=True)
    do = shlib.place(state, shlib.opt_shardings(state, psh, mesh))
    db = shlib.place(tb, shlib.batch_shardings(tb, mesh))
    step = shlib.make_sharded_train_step(api, opt, mesh, microbatches)
    metrics = []
    for _ in range(steps):
        dp, do, m = step(dp, do, db)
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"embed_local": shlib.local(dp["embed"]["table"]).detach().numpy(),
           "mu_local": shlib.local(do.mu["embed"]["table"]).numpy(),
           "tokens_local": shlib.local(db["tokens"]).numpy(),
           "coord": mesh.get_coordinate()}
    full = [p.full_tensor().detach().numpy() for p in tree_leaves(dp)]
    mu = [p.full_tensor().numpy() for p in tree_leaves(do.mu)]
    if rank == 0:
        out.update(metrics=metrics, params=full, mu=mu,
                   step=int(shlib.local(do.step)))
    return out


def dtensor_to_kernel(rank, world):
    """A DTensor handed to a kernel wrapper raises TypeError."""
    import torch
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.kernels import ops as kops

    mesh = _mesh((world,), ("data",))
    q = distribute_tensor(torch.randn(world * 2, 2, 16, 8), mesh, [Shard(0)],
                          src_data_rank=None)
    try:
        kops.flash_attention(q, q, q)
    except TypeError as e:
        return str(e)
    return None


def constrain_dtensor(rank, world):
    """``constrain`` lays a replicated DTensor activation out by its
    logical axes on a (2, 2) mesh and returns a plain tensor unchanged."""
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.distributed.sharding import (constrain, placements,
                                                  use_mesh)

    mesh = _mesh((2, 2), ("data", "model"))
    x = torch.arange(4 * 6 * 8 * 2, dtype=torch.float32).reshape(4, 6, 8, 2)
    dx = distribute_tensor(x, mesh, [Replicate(), Replicate()],
                           src_data_rank=None)
    plain = torch.ones(3)
    with use_mesh(mesh):
        y = constrain(dx, "batch", "heads", "seq_sp")
        z = constrain(dx, "batch", None, "vocab")
        same = constrain(plain, "batch") is plain
    return {"y": list(y.placements) == placements(("data", "model"), mesh),
            "z": list(z.placements) == placements(("data", None, "model"),
                                                  mesh),
            "y_full_equal": bool(torch.equal(y.full_tensor(), x)),
            "plain_unchanged": same}


def serving_steps(rank, world, shape, names, arch, overrides, jax_params,
                  tokens, prompt):
    """The sharded prefill and decode steps against the single-device
    ones on the same parameters (every rank computes both)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.launch import shardings as shlib
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import box_like
    from repro_torch.train.step import make_prefill_step, make_serve_step

    cfg = get_config(arch).reduced(**overrides)
    api = get_model(cfg)
    mesh = _mesh(shape, names)
    params = params_from_jax(jax_params, cfg, device="cpu")
    _, psh = shlib.params_shardings(box_like(params, api.axes()), mesh)
    dp = shlib.place(params, psh)
    batch = {"tokens": torch.from_numpy(prompt)}
    ref_pre = make_prefill_step(api)(params, batch)
    got_pre = shlib.make_sharded_prefill_step(api, mesh)(
        dp, shlib.place(batch, shlib.batch_shardings(batch, mesh)))
    b = tokens.shape[0]
    states = api.init_states(b, 16, device="cpu")
    tok = torch.from_numpy(tokens)
    ref_nxt, ref_logits, _ = make_serve_step(api)(params, tok, states)
    ds = shlib.place(api.init_states(b, 16, device="cpu"),
                     shlib.state_shardings(states, mesh, b))
    dtok = shlib.place(tok, shlib.batch_shardings({"t": tok}, mesh)["t"])
    nxt, logits, new = shlib.make_sharded_serve_step(api, mesh)(dp, dtok, ds)
    return {"prefill": (ref_pre.numpy(), got_pre.full_tensor().numpy()),
            "next": (ref_nxt.numpy(), nxt.full_tensor().numpy()),
            "logits": (ref_logits.numpy(), logits.full_tensor().numpy()),
            "length": int(new.kv.length.full_tensor().reshape(-1)[0])}


def collectives(rank, world, grads, x, w, ws, xs):
    """On 8 ranks: compressed_grad_sync on (2, 2, 2) ("pod", "data",
    "model") with each rank's own gradients, the ring all-gather matmul
    on an 8-way ``model`` axis (each rank passes its k / n slices), the
    GPipe schedule on a (4, 2) ("pipe", "data") mesh."""
    import torch

    from repro_torch.distributed.collectives import (allgather_matmul,
                                                     compressed_grad_sync)
    from repro_torch.distributed.pipeline import pipeline_apply

    mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
    mine = {k: torch.from_numpy(v[rank]) for k, v in grads.items()}
    out = {"sync": _np(compressed_grad_sync(mine, mesh))}
    mesh = _mesh((world,), ("model",))
    kx, nw = x.shape[1] // world, w.shape[1] // world
    out["matmul"] = allgather_matmul(
        torch.from_numpy(x[:, rank * kx:(rank + 1) * kx]),
        torch.from_numpy(w[:, rank * nw:(rank + 1) * nw]), mesh).numpy()
    mesh = _mesh((4, 2), ("pipe", "data"))
    s = mesh.get_local_rank("pipe")
    out["pipeline"] = pipeline_apply(
        lambda wt, v: torch.tanh(v @ wt), torch.from_numpy(ws[s:s + 1]),
        torch.from_numpy(xs), mesh, num_microbatches=xs.shape[0]).numpy()
    return out


def ckpt_resume(rank, world, shape, names, overrides, root, steps, cut,
                every):
    """``train()`` under a mesh with async checkpoints every ``every``
    steps (keep 2), on the reduced smollm-135m LM stream: ``steps``
    uninterrupted (commits under ``root/full``), then the same run cut at
    ``cut`` and resumed to ``steps`` (under ``root/cut``).  Every rank
    returns its ``store.save`` calls, whether its local shards of the
    two final states are equal, and the placements of the two final
    states and of a fresh ``params_shardings`` / ``opt_shardings``
    placement; rank 0 also the losses and the gathered final state of
    the uninterrupted run."""
    import os

    import torch

    from repro_torch.checkpoint import CheckpointConfig, store
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, lm_batch_at
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch import shardings as shlib
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import box_like
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import TrainConfig, train
    from repro_torch.train.step import init_train_state
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config("smollm-135m").reduced(**overrides)
    api = get_model(cfg)
    mesh = _mesh(shape, names)
    opt = AdamWConfig(lr=1e-3)
    pipe = PipelineConfig(global_batch=8, seq_len=16,
                          vocab_size=cfg.vocab_size, seed=11)
    calls = {}
    real_save = store.save

    def counted(path, step, tree, **kw):
        calls.setdefault(os.path.basename(path), []).append(step)
        return real_save(path, step, tree, **kw)

    store.save = counted

    def run(total, sub):
        ck = CheckpointConfig(os.path.join(root, sub), every_steps=every,
                              keep=2, async_save=True)
        with use_mesh(mesh):
            return train(api, opt, TrainConfig(total_steps=total,
                                               checkpoint=ck),
                         lambda step: lm_batch_at(pipe, step), device="cpu")

    try:
        full = run(steps, "full")
        first = run(cut, "cut")
        resumed = run(steps, "cut")
    finally:
        store.save = real_save
    a = tree_leaves((full["params"], full["opt_state"]))
    b = tree_leaves((resumed["params"], resumed["opt_state"]))
    params, state = init_train_state(api, opt, torch.Generator(),
                                     device="cpu")
    _, psh = shlib.params_shardings(box_like(params, api.axes()), mesh)
    fresh = tree_leaves(tree_map(
        lambda _, sh: str(tuple(sh.placements)), (params, state),
        (psh, shlib.opt_shardings(state, psh, mesh))))
    out = {"saves": calls,
           "shards_equal": [bool(torch.equal(shlib.local(x).detach(),
                                             shlib.local(y).detach()))
                            for x, y in zip(a, b)],
           "placements": {"full": [str(x.placements) for x in a],
                          "resumed": [str(y.placements) for y in b],
                          "fresh": fresh},
           "resumed_params": [(type(p).__name__, p.requires_grad)
                              for p in tree_leaves(resumed["params"])]}
    gathered = [x.detach().full_tensor() for x in a]
    if rank == 0:
        out.update(losses={"full": [h["loss"] for h in full["history"]],
                           "first": [h["loss"] for h in first["history"]],
                           "resumed": [h["loss"]
                                       for h in resumed["history"]]},
                   start=resumed["history"][0]["step"],
                   gathered=[t.numpy().copy() for t in gathered])
    return out


def microbatch_rows(rank, world, rows, splits):
    """``global_microbatches`` of a batch whose row i holds i, placed by
    ``batch_shardings``, on (2, 2, 2) ("pod", "data",
    "model") and on (4, 2) ("data", "model"): for each M in ``splits``
    this rank's rows of each microbatch, or the ``ValueError``'s
    message."""
    import torch

    from repro_torch.distributed.sharding import (batch_index,
                                                  global_microbatches)
    from repro_torch.launch import shardings as shlib

    out = {}
    for shape, names in (((2, 2, 2), ("pod", "data", "model")),
                         ((4, 2), ("data", "model"))):
        mesh = _mesh(shape, names)
        x = torch.arange(rows * 3, dtype=torch.int32).reshape(rows, 3) // 3
        dx = shlib.place({"x": x}, shlib.batch_shardings({"x": x}, mesh))
        got = {}
        for m in splits:
            try:
                got[m] = [t[:, 0].tolist() for t in
                          global_microbatches(dx["x"], m, mesh)]
            except ValueError as e:
                got[m] = str(e)
        out["x".join(map(str, shape))] = {"index": batch_index(mesh),
                                          "rows": got}
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def tp_train(rank, world, shape, names, arch, overrides, jax_params, batch,
             steps, opt_kw, probe, cfg_kw=None):
    """:func:`sharded_train`'s steps, then what shows the tensor-parallel
    split on this rank: whether the first block's layers and the
    embedding were handed split (``ModelShards``), its local query heads
    and experts, the region exits (all-reduces or reduce-scatters) and
    the other region operators in one forward of the sharded loss
    (:class:`_count_regions`), and the gradient of the leaf at
    ``probe`` = (path, dim) as the rank computes it (summed over the
    batch ranks) against the same slice of the one-process gradient of
    the whole batch."""
    from repro_torch.distributed import sharding as sh

    out, gp, _ = _tp_run(rank, world, shape, names, arch, overrides,
                         jax_params, batch, steps, opt_kw, {"probe": probe},
                         cfg_kw)
    got = out.pop("probes")["probe"]
    block = gp["blocks"][0]
    ffn = block.get("ffn", block.get("moe"))
    out.update(
        split={"attn": sh.is_split(block["attn"]),
               "kv_whole": "wk" in getattr(block["attn"], "whole", ()),
               "ffn": sh.is_split(ffn),
               "shared": sh.is_split(ffn.get("shared")),
               "embed": sh.is_split(gp["embed"])},
        q_heads=block["attn"]["wq"]["kernel"].shape[1],
        experts=(ffn["wg"]["kernel"].shape[0] if "router" in ffn else None),
        out_calls=out["regions"]["exits"], probe_shape=got["shape"],
        probe_full_shape=got["full_shape"], probe_err=got["err"])
    return out


def tp_probe(rank, world, shape, names, arch, overrides, jax_params, batch,
             steps, opt_kw, probes, cfg_kw=None):
    """:func:`sharded_train`'s steps, then what shows the split on this
    rank: which layers of the first block were handed split
    (``ModelShards``) and the names they hold whole, the RWKV-6
    time-mix's local heads and the Mamba block's local channels, the
    region operators of one forward of the sharded loss
    (:class:`_count_regions`), and for each leaf path of ``probes`` (name
    -> (path, dim)) the gradient the rank computes (summed over the batch
    ranks) against the same slice of the one-process gradient (``dim``
    None: whole), with the rank's gradient itself."""
    from repro_torch.distributed import sharding as sh

    out, gp, cfg = _tp_run(rank, world, shape, names, arch, overrides,
                           jax_params, batch, steps, opt_kw, probes, cfg_kw)
    block = gp["blocks"][0]
    out["split"] = {k: sorted(v.whole) for k, v in block.items()
                    if sh.is_split(v)}
    if "time_mix" in block:
        tm = block["time_mix"]
        out["heads"] = (tm["receptance"]["kernel"].shape[1] * cfg.attention
                        .num_heads // cfg.d_model)
    if "mamba" in block:
        out["channels"] = block["mamba"]["conv_b"].shape[0]
    return out


def _tp_run(rank, world, shape, names, arch, overrides, jax_params, batch,
            steps, opt_kw, probes, cfg_kw):
    """(:func:`sharded_train`'s results with the ``regions`` of one forward
    of the sharded loss, the gradient ``probes`` and the ``attention``
    calls of that forward (:class:`_record_attention`), the gathered
    parameters, the config) for :func:`tp_train`, :func:`tp_probe` and
    :func:`sp_attention`."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import shardings as shlib
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import box_like
    from repro_torch.train.step import make_loss_fn
    from repro_torch.tree import tree_leaves

    out = sharded_train(rank, world, shape, names, arch, overrides,
                        jax_params, batch, steps, 1, opt_kw, cfg_kw)
    cfg = with_fields(get_config(arch).reduced(**overrides), cfg_kw)
    api = get_model(cfg)
    mesh = _mesh(shape, names)
    params = params_from_jax(jax_params, cfg, device="cpu")
    for t in tree_leaves(params):
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    paths = {k: p for k, (p, _) in probes.items()}
    full = dict(zip(paths, torch.autograd.grad(
        make_loss_fn(api)(params, tb)[0],
        [_get(params, p) for p in paths.values()]) if paths else ()))
    _, psh = shlib.params_shardings(box_like(params, api.axes()), mesh)
    dp = shlib.place(params, psh, requires_grad=True)
    db = shlib.place(tb, shlib.batch_shardings(tb, mesh))
    with sh.use_mesh(mesh):
        with _count_regions() as counter, _record_attention() as attn:
            gp = shlib.gather_params(dp, mesh, cfg=cfg)
            share, _ = shlib._sharded_loss(api, gp, {k: shlib.local(v)
                                                     for k, v in db.items()},
                                           mesh)
        leaves = [_get(gp, p) for p in paths.values()]
        grads = [sh.batch_all_reduce(g, mesh) for g in
                 (torch.autograd.grad(share, leaves) if leaves else ())]
    r = sh.model_rank(mesh)
    got = {}
    for (name, (_, dim)), g in zip(probes.items(), grads):
        want = full[name]
        if dim is not None and g.shape[dim] < want.shape[dim]:
            n = g.shape[dim]
            want = want.narrow(dim, r * n, n)
        got[name] = {"shape": list(g.shape),
                     "full_shape": list(full[name].shape),
                     "err": float((g - want).abs().max()
                                  / full[name].abs().max()),
                     "grad": g.detach().numpy().copy()}
    out.update(regions=counter.counts, probes=got, attention=attn.calls)
    return out, gp, cfg


class _count_regions:
    """Counts, while active, the calls of the region operators over
    ``model`` in this rank's forwards: ``out_of_model`` (an all-reduce),
    ``enter_summed`` / ``enter_own`` (a sequence's all-gather whose
    backward reduce-scatters / takes the rank's positions), ``exit`` (a
    reduce-scatter over the sequence), ``own`` (a whole output sliced to
    the rank's positions); ``exits`` is the region exits in either form
    (``out_of_model`` + ``exit``); ``seq_shapes`` the shapes that enter
    and leave over the sequence (the residual's)."""

    OPS = (("_OutOfModel", "out_of_model"), ("_EnterSeq", None),
           ("_ExitSeq", "exit"), ("_OwnSeq", "own"))

    def __enter__(self):
        from repro_torch.distributed import sharding as sh

        counts = {"out_of_model": 0, "enter_summed": 0, "enter_own": 0,
                  "exit": 0, "own": 0}
        shapes = set()
        self.counts, self.shapes, self.saved = counts, shapes, {}
        for cls, name in self.OPS:
            fn = getattr(sh, cls)
            forward = self.saved[cls] = fn.forward

            def counting(ctx, x, *args, _fwd=forward, _name=name):
                out = _fwd(ctx, x, *args)
                if _name is None:
                    counts["enter_summed" if args[-1] else "enter_own"] += 1
                    shapes.add(tuple(x.shape))
                else:
                    counts[_name] += 1
                    if _name == "exit":
                        shapes.add(tuple(out.shape))
                return out

            fn.forward = staticmethod(counting)
        return self

    def __exit__(self, *exc):
        from repro_torch.distributed import sharding as sh

        for cls, forward in self.saved.items():
            getattr(sh, cls).forward = staticmethod(forward)
        self.counts["exits"] = self.counts["out_of_model"] + self.counts[
            "exit"]
        self.counts["seq_shapes"] = sorted(self.shapes)
        return False


class _record_attention:
    """Records, while active, every attention this rank computes
    (``core.attention.apply_attention``), in call order: its query and
    key rows (``q``, ``k``: the shapes its backend gets), the query
    offset of its mask (``offset``: None where it builds none, the
    cross-attention), and the RoPE positions of its queries and keys
    (``q_positions``, ``k_positions``: row 0's, None without RoPE)."""

    def __enter__(self):
        from repro_torch.core import attention as att
        from repro_torch.nn import rotary

        self.calls, self.saved = [], {}
        pending = {"offset": None, "rope": []}
        calls = self.calls

        def build_mask(cfg, n_q, n_k, q_offset, *args, **kw):
            pending["offset"] = int(q_offset)
            return self.saved["_build_mask"](cfg, n_q, n_k, q_offset, *args,
                                             **kw)

        def rope(x, positions, **kw):
            pending["rope"].append(positions[0].tolist())
            return self.saved["apply_rope"](x, positions, **kw)

        def execute(plan, q, k, v, **kw):
            structural = kw.get("structural")
            offset = pending["offset"]
            if structural is not None:
                offset = int(structural.q_offset)
            rope_rows = pending["rope"] or [None, None]
            calls.append({"q": list(q.shape), "k": list(k.shape),
                          "offset": offset, "q_positions": rope_rows[0],
                          "k_positions": rope_rows[1],
                          "backend": plan.backend})
            pending.update(offset=None, rope=[])
            return self.saved["execute_plan"](plan, q, k, v, **kw)

        for mod, name, fn in ((att, "_build_mask", build_mask),
                              (rotary, "apply_rope", rope),
                              (att, "execute_plan", execute)):
            self.saved[name] = getattr(mod, name)
            setattr(mod, name, fn)
        self.mods = {"_build_mask": att, "apply_rope": rotary,
                     "execute_plan": att}
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.mods[name], name, fn)
        return False


def sp_attention(rank, world, shape, names, arch, overrides, jax_params,
                 batch, steps, opt_kw, probes, cfg_kw=None):
    """:func:`sharded_train`'s steps, then one forward of the sharded loss
    on this rank (:func:`_tp_run`): its region operators, every attention
    as the rank computed it (:class:`_record_attention`), the gradient
    ``probes``; and the paths of the attentions handed split."""
    from repro_torch.distributed import sharding as sh

    out, gp, _ = _tp_run(rank, world, shape, names, arch, overrides,
                         jax_params, batch, steps, opt_kw, probes, cfg_kw)

    def attentions(node, path=()):
        if isinstance(node, dict):
            if "wq" in node:
                yield path, node
                return
            for k in sorted(node):
                yield from attentions(node[k], path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, x in enumerate(node):
                yield from attentions(x, path + (i,))

    out["split_attn"] = ["/".join(map(str, p)) for p, a in attentions(gp)
                         if sh.is_split(a)]
    return out


def vocab_nll(rank, world, logits, labels, weights):
    """The vocab-parallel NLL on a ``model`` axis of ``world`` ranks, each
    holding its columns of ``logits``: per dtype, the per-token NLL and
    the gradient of Σ weights · NLL with respect to the rank's columns."""
    import torch

    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch import shardings as shlib

    mesh = _mesh((world,), ("model",))
    cols = logits.shape[-1] // world
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(logits[..., rank * cols:(rank + 1) * cols]).to(
            dtype).requires_grad_(True)
        with use_mesh(mesh):
            nll = shlib._token_nll(x, torch.from_numpy(labels), True)
            grad = torch.autograd.grad(
                (nll * torch.from_numpy(weights)).sum(), x)[0]
        out[str(dtype)] = (nll.detach().numpy(), grad.float().numpy())
    return out


def tp_serving(rank, world, cases):
    """The sharded prefill and serve steps against the single-device ones
    on the same parameters, per case (mesh shape, arch, overrides, JAX
    parameters, prompt, decode tokens (steps, b, 1)): the prefill's
    last-position logits, each decode step's logits and next tokens, and
    after the last step the whole KV cache (each rank's kv heads gathered
    back over ``model``) and its cursor, and every leaf of the decode
    state (the WKV state and the Mamba carries whole)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.launch import shardings as shlib
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import box_like
    from repro_torch.train.step import make_prefill_step, make_serve_step
    from repro_torch.tree import tree_flatten_with_path

    out = []
    for shape, arch, overrides, jax_params, prompt, tokens in cases:
        cfg = get_config(arch).reduced(**overrides)
        api = get_model(cfg)
        mesh = _mesh(shape, ("data", "model"))
        params = params_from_jax(jax_params, cfg, device="cpu")
        _, psh = shlib.params_shardings(box_like(params, api.axes()), mesh)
        dp = shlib.place(params, psh)
        batch = {"tokens": torch.from_numpy(prompt)}
        got = {"prefill": (make_prefill_step(api)(params, batch).numpy(),
                           shlib.make_sharded_prefill_step(api, mesh)(
                               dp, shlib.place(batch, shlib.batch_shardings(
                                   batch, mesh))).full_tensor().numpy())}
        b = tokens.shape[1]
        states = api.init_states(b, 16, device="cpu")
        ds = shlib.place(api.init_states(b, 16, device="cpu"),
                         shlib.state_shardings(states, mesh, b))
        ref_step = make_serve_step(api)
        step = shlib.make_sharded_serve_step(api, mesh)
        got["steps"] = []
        for t in tokens:
            tok = torch.from_numpy(t)
            ref_nxt, ref_logits, states = ref_step(params, tok, states)
            nxt, logits, ds = step(dp, shlib.place(tok, shlib.batch_shardings(
                {"t": tok}, mesh)["t"]), ds)
            got["steps"].append((ref_logits.numpy(),
                                 logits.full_tensor().numpy(),
                                 ref_nxt.numpy(), nxt.full_tensor().numpy()))
        if getattr(states, "kv", None) is not None:
            got["kv"] = [(getattr(states.kv, f).numpy(),
                          getattr(ds.kv, f).full_tensor().numpy())
                         for f in ("k", "v")]
            got["length"] = (states.kv.length.numpy(),
                             ds.kv.length.full_tensor().numpy())
        got["states"] = [
            ("/".join(map(str, path)), want.float().numpy(),
             have.full_tensor().float().numpy())
            for (path, want), (_, have) in zip(
                tree_flatten_with_path(states), tree_flatten_with_path(ds))]
        out.append(got)
    return out
