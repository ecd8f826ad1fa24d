"""stablelm-1.6b (stablelm-2-1_6b) — dense MHA LM, LayerNorm, partial RoPE.
[hf:stabilityai/stablelm-2-1_6b; unverified]
24L d_model=2048 32H (kv=32) d_ff=5632 vocab=100352, head_dim=64,
rotary_pct=0.25.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import AttentionConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    d_ff=5632,
    vocab_size=100352,
    attention=AttentionConfig(
        mechanism="dotprod", num_heads=32, num_kv_heads=32, head_dim=64,
        qkv_bias=False, use_rope=True, rope_base=10000.0, rope_pct=0.25,
        causal=True),
    norm="layernorm",
    norm_eps=1e-5,
    mlp="gated_silu",
    tie_embeddings=False,
    max_seq_len=4096,
    source="hf:stabilityai/stablelm-2-1_6b",
)
