"""llava-next-mistral-7b — VLM: Mistral-7B backbone + anyres patch stub.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, head_dim=128.

The vision tower is a stub, as in the reference: ``input_specs``
provides precomputed patch embeddings for up to 5 anyres tiles × 576
patches (b, 2880, 1024), projected into the LM embedding space by
``frontend_proj`` and prepended to the token embeddings.  The language
backbone is the dense family's.
"""

from repro_torch.configs.base import FrontendConfig, ModelConfig
from repro_torch.core.attention import AttentionConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=32000,
    attention=AttentionConfig(
        mechanism="dotprod", num_heads=32, num_kv_heads=8, head_dim=128,
        qkv_bias=False, use_rope=True, rope_base=1000000.0, causal=True),
    norm="rmsnorm",
    norm_eps=1e-5,
    mlp="gated_silu",
    frontend=FrontendConfig(kind="vision", embed_dim=1024,
                            tokens_per_item=576, max_tiles=5),
    tie_embeddings=False,
    max_seq_len=32768,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
