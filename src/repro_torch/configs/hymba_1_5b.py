"""hymba-1.5b — hybrid-head LM: parallel attention + mamba heads per layer.
[arXiv:2411.13676; hf:nvidia/Hymba-1.5B]
32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16,
head_dim=64.

Per the paper, attention and SSM branches process the same input in
parallel and their (normalized, scaled) outputs are averaged.  Most
attention layers use a sliding window; this config applies window 1024 to
the attention branch of every layer (meta-tokens and the 3 global-attention
layers of the release are simplifications recorded in DESIGN.md) — which,
combined with the O(1) SSM state, keeps the architecture sub-quadratic and
eligible for the long_500k shape.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.core.attention import AttentionConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    d_ff=5504,
    vocab_size=32001,
    attention=AttentionConfig(
        mechanism="dotprod", num_heads=25, num_kv_heads=5, head_dim=64,
        qkv_bias=False, use_rope=True, rope_base=10000.0, causal=True,
        sliding_window=1024),
    norm="rmsnorm",
    norm_eps=1e-6,
    mlp="gated_silu",
    ssm=SSMConfig(kind="mamba", state_dim=16, inner_dim=3200, conv_dim=4),
    tie_embeddings=True,
    max_seq_len=8192,
    source="arXiv:2411.13676",
)
