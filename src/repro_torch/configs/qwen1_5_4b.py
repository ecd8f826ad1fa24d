"""qwen1.5-4b — dense MHA LM with QKV bias.
[hf:Qwen/Qwen1.5-4B]
40L d_model=2560 20H (kv=20) d_ff=6912 vocab=151936, head_dim=128.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import AttentionConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    d_ff=6912,
    vocab_size=151936,
    attention=AttentionConfig(
        mechanism="dotprod", num_heads=20, num_kv_heads=20, head_dim=128,
        qkv_bias=True, use_rope=True, rope_base=5000000.0, causal=True),
    norm="rmsnorm",
    norm_eps=1e-6,
    mlp="gated_silu",
    tie_embeddings=False,
    max_seq_len=32768,
    source="hf:Qwen/Qwen1.5-4B",
)
