"""Synthetic data and the deterministic LM batch pipeline (numpy)."""

from repro_torch.data.pipeline import PipelineConfig, lm_batch_at  # noqa: F401
