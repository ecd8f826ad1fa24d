"""A training cell: the program's train step over as many steps as fit the
window, on the LM stream, checked against the reference's first steps.

Set-up builds one object, the program's step with its parameters and
AdamW state, drives it through the first ``check_steps`` steps on the
window's own feed (recording the losses, the first gradient from the
optimizer's state and, after the last, each parameter's change), and
hands that same object to the window.  The window runs whole steps until
its seconds have passed, each ending in a read of its loss (a
synchronize); the rate is the tokens of every step over the time from the
window's start to the last step's end.  A traced run then traces
``trace_steps`` more steps.  Once the window has closed and the peak
memory is read, the program's state is freed and the reference follows
the first steps from weights drawn again from the seed.

A cell over several chips (its traffic names a ("data", "model") mesh)
runs the same steps in one process a rank (``harness.ranks``), each rank
building the program's sharded step through the port's own entry points
(``make_mesh``, ``use_mesh``, ``params_shardings``, ``place``,
``make_sharded_train_step``) from the very tensors ``weights.draw`` gives
for the seed; the batch is the global batch, every rank drawing it and
keeping its rows.  Rank 0 decides after each step whether the window has
closed and tells the others, so every rank runs the same steps; the rate
is the global tokens over rank 0's window.  The checked steps' norms are
taken of whole leaves, gathered on every rank.  A traced run traces the
same steps on every rank: the breakdown and the per-layer metrics read
rank 0's trace, the busy time is the ranks' mean.  The peak is the fullest
rank's.  Once the ranks have ended, the reference follows the first steps
in this process with each layer on one of the cell's cards.
"""

from __future__ import annotations

import gc
import statistics
import time
import types
from typing import Callable, Optional

import torch

from harness import checks, ranks, reference, traffic, weights
from harness.trace import traced


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def opt_config(train: dict):
    """The program's AdamW settings from the configuration file."""
    from repro_torch.optim import AdamWConfig, warmup_cosine

    return AdamWConfig(
        lr=warmup_cosine(train["lr"], train["warmup_steps"],
                         train["total_steps"], train["final_frac"]),
        b1=train["b1"], b2=train["b2"], eps=train["eps"],
        weight_decay=train["weight_decay"],
        grad_clip_norm=train["grad_clip_norm"])


def batch(mix, model, seed, step, device):
    toks, labels = traffic.lm_batch(mix, model["vocab_size"], seed, step)
    return {"tokens": torch.from_numpy(toks).to(device),
            "labels": torch.from_numpy(labels).to(device)}


def program(cell, api, seed: int, device, *, fault: Optional[str] = None):
    """(step_fn, params, opt_state, paths, AdamW config) of the program,
    the step wrapped by a planted ``fault`` (:func:`planted`)."""
    from repro_torch.optim import init_adamw
    from repro_torch.train.step import make_train_step

    drawn = weights.draw(cell.model, seed, device)
    params = _tree_map(lambda t: t.detach().clone().requires_grad_(True),
                       drawn)
    del drawn
    cfg = opt_config(cell.model["train"])
    opt = init_adamw(params, cfg)
    step = make_train_step(api, cfg)
    return planted(step, fault), params, opt, weights.paths(params), cfg


def sharded_program(cell, api, seed: int, device, mesh, *,
                    fault: Optional[str] = None):
    """:func:`program` on ``mesh``: the seed's tensors placed by the
    program's rules, AdamW's moments as zeros of the same placements, the
    program's sharded step, which the returned step feeds the global batch
    placed over the batch axes."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import shardings as shlib
    from repro_torch.nn.module import box_like
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.tree import tree_map

    drawn = weights.draw(cell.model, seed, device)
    paths = weights.paths(drawn)
    _, psh = shlib.params_shardings(box_like(drawn, api.axes()), mesh)

    def placed(t, sh):
        # leaf by leaf: ``place`` copies the whole leaf and keeps a shard of
        # its leading dim as a view of that copy; a copy of the shard frees
        # the rest, so a rank holds its shards and one whole leaf at most
        dt = shlib.place(t, sh)
        loc = dt.to_local()
        if loc.untyped_storage().nbytes() > loc.numel() * loc.element_size():
            dt = DTensor.from_local(loc.clone(), mesh, dt.placements,
                                    shape=dt.shape, stride=dt.stride())
        return dt.requires_grad_(True)

    params = tree_map(placed, drawn, psh)
    del drawn
    cfg = opt_config(cell.model["train"])
    with torch.no_grad():
        opt = AdamWState(
            step=shlib.place(torch.zeros((), dtype=torch.int32,
                                         device=device),
                             shlib.replicated(mesh)),
            mu=_tree_map(torch.zeros_like, params),
            nu=_tree_map(torch.zeros_like, params))
    step = shlib.make_sharded_train_step(api, cfg, mesh)

    def placed_step(p, o, b):
        return step(p, o, shlib.place(b, shlib.batch_shardings(b, mesh)))

    return planted(placed_step, fault), params, opt, paths, cfg


def planted(step, fault: Optional[str]):
    """``step`` with a fault planted for the harness's own tests:
    "unchanged" returns the state as it came, "half_batch" drops the
    second half of every (global) batch."""
    if fault == "unchanged":
        def step_fn(p, o, b):
            saved = [t.detach().clone() for t in weights.leaves(p)]
            out = step(p, o, b)
            with torch.no_grad():
                for t, s in zip(weights.leaves(p), saved):
                    t.copy_(s)
            return out
    elif fault == "half_batch":
        def step_fn(p, o, b):
            half = b["tokens"].shape[0] // 2
            return step(p, o, {k: v[:half] for k, v in b.items()})
    elif fault is None:
        step_fn = step
    else:
        raise ValueError(f"unknown fault {fault!r}")
    return step_fn


def _whole(t):
    """A leaf whole: a sharded one gathered (on every rank)."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def first_steps(cell, step_fn, params, opt, paths, cfg, seed, device):
    """Drive the program through the checked steps on the window's feed:
    the losses, the first gradient as the optimizer got it (its first
    moment over 1 - b1) and each parameter's change, leaf by leaf.
    Returns (readings, params, opt_state) after those steps."""
    model, mix = cell.model, cell.mix
    p0 = [_at(params, p).detach().clone() for p in paths]
    prog = {"losses": []}
    for i in range(model["train"]["check_steps"]):
        params, opt, m = step_fn(params, opt, batch(mix, model, seed, i,
                                                    device))
        prog["losses"].append(float(m["loss"]))
        if i == 0:
            prog["grad_norms"] = [
                float(_whole(_at(opt.mu, p)).float().norm() / (1 - cfg.b1))
                for p in paths]
    prog["change_norms"] = [float(_whole(_at(params, p).detach() - s).norm())
                            for p, s in zip(paths, p0)]
    return prog, params, opt


def measure(cell, step_fn, params, opt, paths, cfg, seed: int,
            seconds: float, trace: bool, device, sync: Callable[[], None],
            closed: Callable[[float], bool]) -> dict:
    """The checked steps, then the window: whole steps until
    ``closed(seconds since its start)``, each ending in a read of its loss;
    with ``trace`` the traced steps after it; then the peak memory."""
    model, mix = cell.model, cell.mix
    prog, params, opt = first_steps(cell, step_fn, params, opt, paths, cfg,
                                    seed, device)
    sync()
    t0 = time.perf_counter()
    steps, failed, step = 0, 0, model["train"]["check_steps"]
    while True:
        params, opt, m = step_fn(params, opt, batch(mix, model, seed, step,
                                                    device))
        loss = float(m["loss"])
        failed += not checks.finite(loss)
        steps += 1
        step += 1
        if closed(time.perf_counter() - t0):
            break
    sync()
    t1 = time.perf_counter()

    tail = {}
    if trace:
        with traced("bench.trace", tail):
            for _ in range(mix["trace_steps"]):
                with torch.profiler.record_function("bench.train_step"):
                    params, opt, m = step_fn(params, opt, batch(
                        mix, model, seed, step, device))
                    float(m["loss"])
                step += 1
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    return {"prog": prog, "t0": t0, "t1": t1, "steps": steps,
            "failed": failed, "trace": tail.get("trace"), "peak": peak}


def run(cell, api, seed: int, seconds: float, trace: bool, device,
        t_start: float, *, fault: Optional[str] = None,
        sync: Callable[[], None] = lambda: None) -> dict:
    if cell.mesh != (1, 1):
        return run_ranks(cell, api.cfg, seed, seconds, trace, device,
                         t_start, fault=fault)
    step_fn, params, opt, paths, cfg = program(cell, api, seed, device,
                                               fault=fault)
    got = measure(cell, step_fn, params, opt, paths, cfg, seed, seconds,
                  trace, device, sync, lambda elapsed: elapsed >= seconds)
    del params, opt, step_fn
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return _outcome(cell, seed, [device], t_start, got)


def rank_run(rank: int, device, cell, cfg, seed: int, seconds: float,
             trace: bool, fault: Optional[str]) -> dict:
    """One rank of a cell over a mesh (``ranks.launch`` calls it in the
    rank's process, its group joined): rank 0's :func:`measure`, or
    another rank's peak and busy time."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import get_model

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dist.barrier()

    def closed(elapsed: float) -> bool:
        # rank 0's clock decides for every rank
        flag = torch.tensor([float(rank == 0 and elapsed >= seconds)],
                            device=device)
        dist.broadcast(flag, 0)
        return bool(flag.item())

    mesh = make_mesh(*cell.mesh)
    with use_mesh(mesh):
        api = get_model(cfg)
        step_fn, params, opt, paths, ocfg = sharded_program(
            cell, api, seed, device, mesh, fault=fault)
        got = measure(cell, step_fn, params, opt, paths, ocfg, seed,
                      seconds, trace, device, sync, closed)
    tr = got["trace"]
    got["busy_us"] = tr.busy_us() if tr is not None else None
    if rank:
        got = {"peak": got["peak"], "busy_us": got["busy_us"]}
    return got


def run_ranks(cell, cfg, seed: int, seconds: float, trace: bool, device,
              t_start: float, *, fault: Optional[str] = None) -> dict:
    """The cell on its mesh, one process a rank; then the reference here,
    each layer on one of the cell's devices."""
    got = ranks.launch(rank_run, cell.chips,
                       (cell, cfg, seed, seconds, trace, fault), device.type)
    first = dict(got[0], peak=max(g["peak"] for g in got))
    if trace:
        first["busy_us"] = statistics.mean(g["busy_us"] for g in got)
    devices = ([torch.device("cuda", r) for r in range(cell.chips)]
               if device.type == "cuda" else [device] * cell.chips)
    return _outcome(cell, seed, devices, t_start, first)


def _outcome(cell, seed: int, devices: list, t_start: float,
             got: dict) -> dict:
    """The run's record: the window's numbers, and the readings against
    the reference, which runs now, the program's state freed."""
    mix = cell.mix
    t0, t1, steps = got["t0"], got["t1"], got["steps"]
    t_ref = time.perf_counter()
    ref = reference_train(cell, seed, devices)
    readings = checks.train_readings(got["prog"], ref)
    out = {
        "attempted": steps, "failed": got["failed"],
        "e2e": {"train_tokens_per_s": steps * mix["batch"] * mix["seq_len"]
                / (t1 - t0),
                "setup_s": t0 - t_start},
        "readings": readings, "program": got["prog"],
        "memory_peak_bytes": got["peak"],
        "reference_s": time.perf_counter() - t_ref,
        "r": types.SimpleNamespace(
            kind="train", model=cell.model, mix=mix, window_s=t1 - t0,
            window_steps=steps, trace=got["trace"], chips=cell.chips,
            mesh=cell.mesh),
    }
    if got.get("busy_us") is not None:
        out["busy_us"] = got["busy_us"]
    return out


def reference_train(cell, seed: int, device,
                    prec: Optional[str] = None) -> dict:
    """The reference's first steps from the seed's weights and batches:
    losses, the first clipped gradient's norm and each parameter's change,
    leaf by leaf in the program's order.  ``device`` is one device, or a
    list of devices over which the layers are spread (``reference.spread``:
    the weights drawn on the first, as the program draws them)."""
    devices = list(device) if isinstance(device, (list, tuple)) else [device]
    model, mix, train = cell.model, cell.mix, cell.model["train"]
    drawn = weights.draw(model, seed, devices[0])
    params = reference.spread(drawn, devices)
    del drawn
    leaves = weights.leaves(params)
    p0 = [t.detach().clone() for t in leaves]
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    out = {"losses": []}
    with reference.exact_float32():
        for i in range(train["check_steps"]):
            b = batch(mix, model, seed, i, devices[0])
            loss = reference.loss(params, model, b["tokens"], b["labels"],
                                  prec)
            grads = reference.grads(loss, leaves)
            out["losses"].append(float(loss.detach()))
            clipped = reference.adamw(leaves, list(grads), mu, nu, i + 1,
                                      train)
            if i == 0:
                out["grad_norms"] = [float(g.norm()) for g in clipped]
            del grads, clipped, loss
    out["change_norms"] = [float((t.detach() - s).norm())
                           for t, s in zip(leaves, p0)]
    return out
