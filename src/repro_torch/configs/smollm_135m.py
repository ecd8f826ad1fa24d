"""smollm-135m — llama-arch small dense LM.
[hf:HuggingFaceTB/SmolLM-135M; hf]
30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152, head_dim=64.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import AttentionConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    d_ff=1536,
    vocab_size=49152,
    attention=AttentionConfig(
        mechanism="dotprod", num_heads=9, num_kv_heads=3, head_dim=64,
        qkv_bias=False, use_rope=True, rope_base=10000.0, causal=True),
    norm="rmsnorm",
    norm_eps=1e-5,
    mlp="gated_silu",
    tie_embeddings=True,
    max_seq_len=32768,
    source="hf:HuggingFaceTB/SmolLM-135M",
)
