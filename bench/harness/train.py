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
"""

from __future__ import annotations

import gc
import time
import types
from typing import Callable, Optional

import torch

from harness import checks, reference, traffic, weights
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
    """(step_fn, params, opt_state, paths) of the program, the step
    wrapped by a planted ``fault`` for the harness's own tests:
    "unchanged" returns the state as it came, "half_batch" drops the
    second half of every batch."""
    from repro_torch.optim import init_adamw
    from repro_torch.train.step import make_train_step

    drawn = weights.draw(cell.model, seed, device)
    params = _tree_map(lambda t: t.detach().clone().requires_grad_(True),
                       drawn)
    del drawn
    cfg = opt_config(cell.model["train"])
    opt = init_adamw(params, cfg)
    step = make_train_step(api, cfg)
    if fault == "unchanged":
        def step_fn(p, o, b, _step=step):
            saved = [t.detach().clone() for t in weights.leaves(p)]
            out = _step(p, o, b)
            with torch.no_grad():
                for t, s in zip(weights.leaves(p), saved):
                    t.copy_(s)
            return out
    elif fault == "half_batch":
        def step_fn(p, o, b, _step=step):
            half = b["tokens"].shape[0] // 2
            return _step(p, o, {k: v[:half] for k, v in b.items()})
    elif fault is None:
        step_fn = step
    else:
        raise ValueError(f"unknown fault {fault!r}")
    return step_fn, params, opt, weights.paths(params), cfg


def first_steps(cell, step_fn, params, opt, paths, cfg, seed, device) -> dict:
    """Drive the program through the checked steps on the window's feed:
    the losses, the first gradient as the optimizer got it (its first
    moment over 1 - b1) and each parameter's change, leaf by leaf."""
    model, mix = cell.model, cell.mix
    p0 = [t.detach().clone() for t in weights.leaves(params)]
    prog = {"losses": []}
    for i in range(model["train"]["check_steps"]):
        params, opt, m = step_fn(params, opt, batch(mix, model, seed, i,
                                                    device))
        prog["losses"].append(float(m["loss"]))
        if i == 0:
            prog["grad_norms"] = [
                float(_at(opt.mu, p).float().norm() / (1 - cfg.b1))
                for p in paths]
    prog["change_norms"] = [float((t.detach() - s).norm()) for t, s in
                            zip(weights.leaves(params), p0)]
    return prog


def run(cell, api, seed: int, seconds: float, trace: bool, device,
        t_start: float, *, fault: Optional[str] = None,
        sync: Callable[[], None] = lambda: None) -> dict:
    model, mix, train = cell.model, cell.mix, cell.model["train"]
    n_check = train["check_steps"]
    step_fn, params, opt, paths, cfg = program(cell, api, seed, device,
                                               fault=fault)
    prog = first_steps(cell, step_fn, params, opt, paths, cfg, seed, device)
    # the window
    sync()
    t0 = time.perf_counter()
    steps, failed, step = 0, 0, n_check
    while True:
        params, opt, m = step_fn(params, opt, batch(mix, model, seed, step,
                                                    device))
        loss = float(m["loss"])
        failed += not checks.finite(loss)
        steps += 1
        step += 1
        if time.perf_counter() - t0 >= seconds:
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
    del params, opt, m, step_fn
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = reference_train(cell, seed, device)
    readings = checks.train_readings(prog, ref)
    return {
        "attempted": steps, "failed": failed,
        "e2e": {"train_tokens_per_s": steps * mix["batch"] * mix["seq_len"]
                / (t1 - t0),
                "setup_s": t0 - t_start},
        "readings": readings, "memory_peak_bytes": peak,
        "reference_s": time.perf_counter() - t_ref,
        "r": types.SimpleNamespace(
            kind="train", model=model, mix=mix, window_s=t1 - t0,
            window_steps=steps, trace=tail.get("trace")),
    }


def reference_train(cell, seed: int, device,
                    prec: Optional[str] = None) -> dict:
    """The reference's first steps from the seed's weights and batches:
    losses, the first clipped gradient's norm and each parameter's change,
    leaf by leaf in the program's order."""
    model, mix, train = cell.model, cell.mix, cell.model["train"]
    drawn = weights.draw(model, seed, device)
    params = _tree_map(lambda t: t.detach().clone().requires_grad_(True),
                       drawn)
    del drawn
    leaves = weights.leaves(params)
    p0 = [t.detach().clone() for t in leaves]
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    out = {"losses": []}
    with reference.exact_float32():
        for i in range(train["check_steps"]):
            b = batch(mix, model, seed, i, device)
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
