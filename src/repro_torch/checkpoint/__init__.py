"""Checkpointing: atomic sharded store + async manager."""

from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointConfig, CheckpointManager)
from repro_torch.checkpoint.store import (  # noqa: F401
    committed_steps, latest_step, restore, retain, save)
