"""qwen2-0.5b — dense GQA LM with QKV bias.
[arXiv:2407.10671; hf:Qwen/Qwen2-0.5B]
24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936, head_dim=64.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import AttentionConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    d_ff=4864,
    vocab_size=151936,
    attention=AttentionConfig(
        mechanism="dotprod", num_heads=14, num_kv_heads=2, head_dim=64,
        qkv_bias=True, use_rope=True, rope_base=1000000.0, causal=True),
    norm="rmsnorm",
    norm_eps=1e-6,
    mlp="gated_silu",
    tie_embeddings=True,
    max_seq_len=131072,
    source="arXiv:2407.10671",
)
