"""Synthetic data and the deterministic LM batch pipeline (numpy)."""

from repro_torch.data.pipeline import (  # noqa: F401
    PipelineConfig, Prefetcher, lm_batch_at)
