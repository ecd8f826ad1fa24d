"""The paper's own experimental scale: a single-layer Inhibitor
Transformer (signed inhibitor attention, shifted score α=0.5, γ=√d,
classic ReLU FFN, LayerNorm)."""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import AttentionConfig

CONFIG = ModelConfig(
    name="paper-tiny",
    family="dense",
    num_layers=1,
    d_model=128,
    d_ff=256,
    vocab_size=256,
    attention=AttentionConfig(
        mechanism="inhibitor", num_heads=4, num_kv_heads=4, head_dim=32,
        score_shift=0.5, use_rope=False, causal=True),
    norm="layernorm",
    norm_eps=1e-5,
    mlp="mlp_relu",
    mlp_bias=True,
    tie_embeddings=False,
    max_seq_len=512,
    compute_dtype="float32",
    remat="none",
    source="paper (Brännvall & Stoian 2024)",
)
