"""Model configuration: architecture widths, dtypes and the attention block.

Port of :mod:`repro.configs.base` for every family: dense, MoE
(``moe``), hybrid attention ∥ Mamba (``hybrid``), RWKV-6 (``ssm``), the
encoder-decoder (``encdec``, :class:`EncDecConfig`) and the vlm family,
whose frontend stub (:class:`FrontendConfig`) projects precomputed
patch or frame embeddings into the model.  Field names and defaults
match the reference so that a config compares field by field; the
JAX-only ``unroll`` knob is left out.  ``remat`` selects activation
checkpointing per block in training (``models.transformer``,
``models.rwkv``, ``models.encdec``).  :data:`SHAPES` are the reference's
four input shapes, which ``ModelApi.input_specs`` describes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.attention import AttentionConfig

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_hidden_dim: int
    shared_hidden_dim: int = 0
    shared_gate: bool = False
    capacity_factor: float = 1.25
    normalize_topk: bool = True
    # pad the expert axis up to a multiple of the EP degree (e.g. 60 -> 64)
    padded_experts: Optional[int] = None
    lb_loss_weight: float = 0.01
    z_loss_weight: float = 1e-3

    @property
    def effective_experts(self) -> int:
        return self.padded_experts or self.num_experts


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba"            # mamba | rwkv6
    state_dim: int = 16
    inner_dim: Optional[int] = None
    conv_dim: int = 4
    dt_rank: Optional[int] = None
    # rwkv6
    lora_dim: int = 64
    decay_lora_dim: int = 64


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    encoder_layers: int = 24
    decoder_layers: int = 24
    # frontend stub: encoder input is precomputed frame embeddings
    max_source_len: int = 4096


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    kind: str = "vision"           # vision | audio
    embed_dim: int = 1024          # frontend output dim (projected to d_model)
    tokens_per_item: int = 576     # patches per tile / frames per clip
    max_tiles: int = 5             # llava-next anyres


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | encdec | ssm | vlm
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
    rope_pct: float = 1.0          # fraction of head_dim rotated (stablelm)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encdec: Optional[EncDecConfig] = None
    frontend: Optional[FrontendConfig] = None
    max_seq_len: int = 131072
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # remat policy per block in training: "none" | "full" | "dots" |
    # "offload" ("offload" checkpoints nothing, as in the reference)
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

    def with_layers(self, n: int) -> "ModelConfig":
        """Depth-n variant (the depth cut of runs that do not fit the card
        at full depth); an encoder-decoder keeps n layers in each stack."""
        kw = dict(num_layers=n)
        if self.encdec is not None:
            kw["encdec"] = dataclasses.replace(
                self.encdec, encoder_layers=n, decoder_layers=n)
        return dataclasses.replace(self, **kw)

    def reduced(self, *, num_layers=2, d_model=64, d_ff=128, vocab_size=256,
                num_heads=4, num_kv_heads=2, head_dim=16,
                max_seq_len=512) -> "ModelConfig":
        """A tiny same-family config for CPU tests (float32 compute, no
        remat)."""
        attn = dataclasses.replace(
            self.attention, num_heads=num_heads, num_kv_heads=num_kv_heads,
            head_dim=head_dim)
        kw = dict(num_layers=num_layers, d_model=d_model, d_ff=d_ff,
                  vocab_size=vocab_size, attention=attn,
                  max_seq_len=max_seq_len, remat="none",
                  compute_dtype="float32")
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=min(2, self.moe.top_k),
                expert_hidden_dim=32,
                shared_hidden_dim=32 if self.moe.shared_hidden_dim else 0,
                padded_experts=None)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, state_dim=8, inner_dim=d_model * 2
                if self.ssm.inner_dim else None, lora_dim=8,
                decay_lora_dim=8)
        if self.encdec is not None:
            kw["encdec"] = dataclasses.replace(
                self.encdec, encoder_layers=num_layers,
                decoder_layers=num_layers, max_source_len=64)
        if self.frontend is not None:
            kw["frontend"] = dataclasses.replace(
                self.frontend, embed_dim=32, tokens_per_item=8, max_tiles=2)
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# The four assigned input shapes (LM-family)
SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}
