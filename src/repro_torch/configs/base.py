"""Model configuration: architecture widths, dtypes and the attention block.

Port of :mod:`repro.configs.base` for the dense slice.  Field names and
defaults match the reference so that a config compares field by field;
the families the port does not run yet (MoE, SSM, encoder-decoder,
frontends) and the JAX-only ``unroll`` knob are left out.  ``remat``
selects activation checkpointing per block in training
(``models.transformer``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.attention import AttentionConfig

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense (the only family of this slice)
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: AttentionConfig
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    norm_eps: float = 1e-6
    mlp: str = "gated_silu"        # gated_silu | mlp_gelu | mlp_relu
    mlp_bias: bool = False
    tie_embeddings: bool = False
    rope_pct: float = 1.0
    max_seq_len: int = 131072
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # remat policy per block in training: "none" | "full" ("dots" and
    # "offload" are not ported yet)
    remat: str = "full"
    source: str = ""

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def with_attention_kind(self, kind: str) -> "ModelConfig":
        # keep both naming fields in sync: ``mechanism`` outranks the
        # legacy ``kind`` in the planner
        return dataclasses.replace(
            self, attention=dataclasses.replace(self.attention, kind=kind,
                                                mechanism=kind))

    def reduced(self, *, num_layers=2, d_model=64, d_ff=128, vocab_size=256,
                num_heads=4, num_kv_heads=2, head_dim=16,
                max_seq_len=512) -> "ModelConfig":
        """A tiny same-family config for CPU tests (float32 compute, no
        remat)."""
        attn = dataclasses.replace(
            self.attention, num_heads=num_heads, num_kv_heads=num_kv_heads,
            head_dim=head_dim)
        return dataclasses.replace(
            self, num_layers=num_layers, d_model=d_model, d_ff=d_ff,
            vocab_size=vocab_size, attention=attn, max_seq_len=max_seq_len,
            remat="none", compute_dtype="float32")
