"""Fault supervision for the training loop: restart supervisor and
straggler watchdog.

Port of the single-process parts of :mod:`repro.distributed.fault`
(pure Python).  ``elastic_remesh_plan`` comes with the distributed slice.
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
