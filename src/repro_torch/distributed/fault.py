"""Fault tolerance: restart supervisor, straggler watchdog, elastic
rescale.

Port of :mod:`repro.distributed.fault` (pure Python).  The unit of
recovery is the committed checkpoint (the checkpoint store is atomic):
any :class:`StepFailure` inside the step loop restores from the last
commit, and since the data is a pure function of (seed, step) the
replay is exact.  ``StepWatchdog`` flags steps slower than ``threshold``
times the trend.  ``elastic_remesh_plan`` computes, for a reduced
healthy chip set, the largest usable (data, model) mesh and whether the
FSDP-sharded state re-slices without resharding collectives (it does
whenever the new data parallelism divides the old).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

log = logging.getLogger("repro_torch.fault")


class StepFailure(RuntimeError):
    """Raised by the training loop when a step fails in a recoverable way
    (device error, NaN loss with strict mode, preemption notice)."""


@dataclasses.dataclass
class SupervisorConfig:
    max_restarts: int = 3
    restart_backoff_s: float = 1.0


def run_supervised(run_fn: Callable[[int], None],
                   cfg: Optional[SupervisorConfig] = None) -> int:
    """Run ``run_fn(attempt)`` under restart supervision: a
    :class:`StepFailure` restarts it until ``max_restarts`` is spent.
    Returns the number of restarts consumed."""
    cfg = cfg or SupervisorConfig()
    attempt = 0
    while True:
        try:
            run_fn(attempt)
            return attempt
        except StepFailure as e:
            attempt += 1
            if attempt > cfg.max_restarts:
                log.error("restart budget exhausted after %d attempts",
                          attempt)
                raise
            log.warning("step failure (%s); restart %d/%d after %.1fs",
                        e, attempt, cfg.max_restarts, cfg.restart_backoff_s)
            time.sleep(cfg.restart_backoff_s)


class StepWatchdog:
    """Robust straggler detector over step wall times."""

    def __init__(self, threshold: float = 2.5, ewma: float = 0.9,
                 warmup_steps: int = 5):
        self.threshold = threshold
        self.ewma = ewma
        self.warmup = warmup_steps
        self._mean: Optional[float] = None
        self._seen = 0
        self.flagged: list = []

    def observe(self, step: int, seconds: float) -> bool:
        """Returns True when ``step`` is a straggler."""
        self._seen += 1
        if self._mean is None:
            self._mean = seconds
            return False
        is_slow = (self._seen > self.warmup
                   and seconds > self.threshold * self._mean)
        if is_slow:
            self.flagged.append((step, seconds, self._mean))
        else:
            # only fold non-straggler steps into the trend
            self._mean = self.ewma * self._mean + (1 - self.ewma) * seconds
        return is_slow


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    data: int
    model: int
    pods: int
    resliceable: bool     # FSDP shards re-slice without gather


def elastic_remesh_plan(healthy_chips: int, *, model_parallelism: int,
                        old_data_parallelism: int,
                        chips_per_pod: int = 256) -> RemeshPlan:
    """Largest mesh on the healthy chip set keeping the TP degree fixed.

    The TP degree is set by the architecture (head / expert
    divisibility), so elasticity trades only the data axis, rounded down
    to a power of two.  The FSDP state re-slices locally iff the new data
    parallelism divides the old; otherwise restore goes through the
    checkpoint reshard path."""
    if healthy_chips < model_parallelism:
        raise ValueError("not enough chips for one model replica")
    new_data = healthy_chips // model_parallelism
    while new_data & (new_data - 1):
        new_data -= 1
    pods = max(1, (new_data * model_parallelism) // chips_per_pod)
    return RemeshPlan(
        data=new_data // pods if pods > 1 else new_data,
        model=model_parallelism,
        pods=pods,
        resliceable=(old_data_parallelism % new_data == 0),
    )
