"""seamless-m4t-large-v2 — encoder-decoder multimodal (audio) transformer.
[arXiv:2308.11596; hf:facebook/seamless-m4t-v2-large]
24L (enc) + 24L (dec) d_model=1024 16H (kv=16) d_ff=8192 vocab=256206,
head_dim=64.

The speech frontend is a stub, as in the reference: ``input_specs``
provides precomputed frame embeddings (b, n_frames, 1024); the conformer
feature extractor is out of scope.  The backbone (self and cross
attention, ReLU FFN with bias, LayerNorm) is the reference's.  With
``use_rope=False`` and no learned positions, neither stack sees a
position: the reference's code does the same.
"""

from repro_torch.configs.base import EncDecConfig, FrontendConfig, ModelConfig
from repro_torch.core.attention import AttentionConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,
    d_model=1024,
    d_ff=8192,
    vocab_size=256206,
    attention=AttentionConfig(
        mechanism="dotprod", num_heads=16, num_kv_heads=16, head_dim=64,
        qkv_bias=True, use_rope=False, causal=True),
    norm="layernorm",
    norm_eps=1e-5,
    mlp="mlp_relu",
    mlp_bias=True,
    encdec=EncDecConfig(encoder_layers=24, decoder_layers=24,
                        max_source_len=4096),
    frontend=FrontendConfig(kind="audio", embed_dim=1024,
                            tokens_per_item=1, max_tiles=1),
    tie_embeddings=False,
    max_seq_len=32768,
    source="arXiv:2308.11596",
)
