"""llama4-scout-17b-a16e — MoE LM, 16 routed experts top-1 + 1 shared expert.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 (expert) vocab=202048,
head_dim=128, MoE 16e top-1, every layer MoE (interleave step 1).

Simplifications recorded in DESIGN.md: QK-norm and the NoPE-every-4th-layer
trick of the released model are omitted; attention/RoPE is uniform llama
style so the layer stack stays scan-homogeneous.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core.attention import AttentionConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    d_ff=8192,
    vocab_size=202048,
    attention=AttentionConfig(
        mechanism="dotprod", num_heads=40, num_kv_heads=8, head_dim=128,
        qkv_bias=False, use_rope=True, rope_base=500000.0, causal=True),
    norm="rmsnorm",
    norm_eps=1e-5,
    mlp="gated_silu",
    moe=MoEConfig(
        num_experts=16, top_k=1, expert_hidden_dim=8192,
        shared_hidden_dim=8192, shared_gate=False,
        normalize_topk=False, capacity_factor=1.25),
    tie_embeddings=False,
    max_seq_len=262144,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
