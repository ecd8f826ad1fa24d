"""Training loop: the train step under a straggler watchdog and a
non-finite-loss check.

Port of :mod:`repro.train.loop` without the checkpoint manager (not
ported yet: ROADMAP).  All state lives in (params, opt_state, step) and
the data is a pure function of the step, so a restarted run replays the
same stream.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.fault import StepFailure, StepWatchdog
from repro_torch.models.registry import ModelApi
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class TrainConfig:
    total_steps: int = 100
    log_every: int = 10
    seed: int = 0
    microbatches: int = 1
    fail_on_nan: bool = True


def train(api: ModelApi, opt_cfg: AdamWConfig, train_cfg: TrainConfig,
          batch_fn: Callable[[int], Dict[str, np.ndarray]], *,
          device=None, hooks: Optional[list] = None) -> dict:
    """Run the loop on ``device`` (default ``cuda``), from parameters drawn
    there from ``train_cfg.seed``; returns {params, opt_state, history}.  Each history entry holds the step's loss and
    its wall seconds (ending in the loss read, which waits for the
    device)."""
    dev = resolve_device(device)
    # parameters drawn on the training device: a CPU generator's one
    # sequential stream takes minutes for billions of parameters
    params, opt_state = init_train_state(
        api, opt_cfg, torch.Generator(device=dev).manual_seed(train_cfg.seed),
        device=dev)
    step_fn = make_train_step(api, opt_cfg, train_cfg.microbatches)
    watchdog = StepWatchdog()
    history = []

    for step in range(train_cfg.total_steps):
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in batch_fn(step).items()}
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
    return {"params": params, "opt_state": opt_state, "history": history}
