"""Training loop: the train step + checkpoint manager + fault supervision.

Port of :mod:`repro.train.loop`.  The loop is restart-pure: all state
lives in (params, opt_state, step), the data is a pure function of the
step, and the checkpoint manager commits atomically — so ``train()``
after a crash resumes from the newest commit and replays the same
stream.  A resumed run loads the commit into the freshly initialised
state in place (the parameters stay leaf tensors that require grad).

Under a mesh (:func:`repro_torch.distributed.sharding.use_mesh`, as the
launcher runs the loop under ``torchrun``) every rank draws the same
parameters, keeps its shard of them and of the AdamW moments as
DTensors (:mod:`repro_torch.launch.shardings`), takes its rows of each
batch, and trains through the sharded step; the history holds the global
loss.  Checkpoints work there too: rank 0 writes one-process commits of
the gathered state (:mod:`repro_torch.checkpoint.manager`), and a
resumed run reads the step rank 0 names, each rank keeping its shards,
which are copied shard into shard into the fresh placement.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import StepFailure, StepWatchdog
from repro_torch.models.registry import ModelApi
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.tree import tree_leaves

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class TrainConfig:
    total_steps: int = 100
    log_every: int = 10
    seed: int = 0
    microbatches: int = 1
    checkpoint: Optional[CheckpointConfig] = None
    fail_on_nan: bool = True


@torch.no_grad()
def _load_into(state, restored) -> None:
    """Copy a restored tree into the live one, leaf for leaf; DTensors
    shard into shard, which needs the live leaf's placements."""
    from repro_torch.launch.shardings import local

    for dst, src in zip(tree_leaves(state), tree_leaves(restored)):
        if (dst.shape != src.shape or dst.dtype != src.dtype
                or getattr(dst, "placements", None)
                != getattr(src, "placements", None)):
            raise ValueError(f"checkpoint leaf {tuple(src.shape)} "
                             f"{src.dtype} does not fit {tuple(dst.shape)} "
                             f"{dst.dtype}")
        local(dst).copy_(local(src))


def _sharded(api, opt_cfg, train_cfg, mesh, params, opt_state, to_device):
    """Place the state on ``mesh`` and build the sharded step; returns
    (params, opt_state, step_fn, batch placer, the state's shardings)."""
    from repro_torch.launch import shardings as shlib
    from repro_torch.nn.module import box_like

    _, psh = shlib.params_shardings(box_like(params, api.axes()), mesh)
    osh = shlib.opt_shardings(opt_state, psh, mesh)
    params = shlib.place(params, psh, requires_grad=True)
    opt_state = shlib.place(opt_state, osh)
    step_fn = shlib.make_sharded_train_step(api, opt_cfg, mesh,
                                            train_cfg.microbatches)

    def placed(b):
        b = to_device(b)
        return shlib.place(b, shlib.batch_shardings(b, mesh))

    return params, opt_state, step_fn, placed, (psh, osh)


def train(api: ModelApi, opt_cfg: AdamWConfig, train_cfg: TrainConfig,
          batch_fn: Callable[[int], Dict[str, np.ndarray]], *,
          device=None, hooks: Optional[list] = None) -> dict:
    """Run the loop on ``device`` (default ``cuda``), from parameters drawn
    there from ``train_cfg.seed`` or, when ``train_cfg.checkpoint`` holds
    a commit, from the newest one; returns {params, opt_state, history}.
    Each history entry holds the step's loss and its wall seconds (ending
    in the loss read, which waits for the device).  With a checkpoint
    config the loop saves every ``every_steps`` steps and at the end, and
    waits for the last write before it returns."""
    from repro_torch.distributed.sharding import current_mesh

    dev = resolve_device(device)
    mesh = current_mesh()
    # parameters drawn on the training device: a CPU generator's one
    # sequential stream takes minutes for billions of parameters
    params, opt_state = init_train_state(
        api, opt_cfg, torch.Generator(device=dev).manual_seed(train_cfg.seed),
        device=dev)
    to_device = lambda b: {k: torch.from_numpy(v).to(dev)  # noqa: E731
                           for k, v in b.items()}
    shardings = None
    if mesh is None:
        step_fn = make_train_step(api, opt_cfg, train_cfg.microbatches)
    else:
        params, opt_state, step_fn, to_device, shardings = _sharded(
            api, opt_cfg, train_cfg, mesh, params, opt_state, to_device)
    mgr = (CheckpointManager(train_cfg.checkpoint, mesh=mesh)
           if train_cfg.checkpoint else None)
    start_step = saved = 0
    if mgr is not None and mgr.latest_step() is not None:
        restored, start_step = mgr.restore((params, opt_state),
                                           device="cpu", shardings=shardings)
        _load_into((params, opt_state), restored)
        saved = start_step
        log.info("resumed from step %d", start_step)

    watchdog = StepWatchdog()
    history = []

    for step in range(start_step, train_cfg.total_steps):
        t0 = time.perf_counter()
        batch = to_device(batch_fn(step))
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0

        if train_cfg.fail_on_nan and not math.isfinite(loss):
            raise StepFailure(f"non-finite loss {loss} at step {step}")
        if watchdog.observe(step, dt):
            log.warning("straggler step %d: %.3fs (trend %.3fs)", step, dt,
                        watchdog._mean)

        history.append({"step": step, "loss": loss, "seconds": dt})
        if step % train_cfg.log_every == 0:
            log.info("step %d loss %.4f (%.3fs)", step, loss, dt)
        if hooks:
            for h in hooks:
                h(step, params, metrics)
        if mgr is not None and mgr.maybe_save(step + 1, (params, opt_state)):
            saved = step + 1

    if mgr is not None:
        # the final state, unless the cadence has just committed it
        if saved != train_cfg.total_steps:
            mgr.save(train_cfg.total_steps, (params, opt_state))
        mgr.wait()
    return {"params": params, "opt_state": opt_state, "history": history}
