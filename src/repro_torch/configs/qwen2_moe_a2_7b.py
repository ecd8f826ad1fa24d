"""qwen2-moe-a2.7b (Qwen1.5-MoE-A2.7B) — 60 routed experts top-4 + 4 shared.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
24L d_model=2048 16H (kv=16) d_ff=1408 (per expert) vocab=151936,
head_dim=128, shared-expert hidden 4×1408=5632 with sigmoid gate.

The expert axis is padded 60 -> 64 for even expert-parallel sharding over
the 16-way model axis (recorded in DESIGN.md).  As in the reference's
``init_moe``, the router draws all 64 columns alike, so at random init a
padding expert is routed to like any other: it is a real expert of the
model, and every expert stack holds 64 experts.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core.attention import AttentionConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    d_ff=1408,
    vocab_size=151936,
    attention=AttentionConfig(
        mechanism="dotprod", num_heads=16, num_kv_heads=16, head_dim=128,
        qkv_bias=True, use_rope=True, rope_base=1000000.0, causal=True),
    norm="rmsnorm",
    norm_eps=1e-6,
    mlp="gated_silu",
    moe=MoEConfig(
        num_experts=60, top_k=4, expert_hidden_dim=1408,
        shared_hidden_dim=5632, shared_gate=True,
        normalize_topk=False, capacity_factor=1.25, padded_experts=64),
    tie_embeddings=False,
    max_seq_len=32768,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
