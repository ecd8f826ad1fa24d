"""rwkv6-7b (Finch) — attention-free RNN/SSM LM with data-dependent decay.
[arXiv:2404.05892; hf:RWKV/rwkv-6-world-7b]
32L d_model=4096 d_ff=14336 vocab=65536; 64 wkv heads of dim 64.

The paper's inhibitor has no attention to replace here: the family runs
without it, and ``get_config`` rejects any attention kind but
``dotprod``.  ``attention`` carries head bookkeeping only (num_heads =
wkv heads).
"""

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.core.attention import AttentionConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65536,
    attention=AttentionConfig(
        mechanism="dotprod", num_heads=64, num_kv_heads=64, head_dim=64,
        use_rope=False, causal=True),
    norm="layernorm",
    norm_eps=1e-5,
    mlp="mlp_relu",
    ssm=SSMConfig(kind="rwkv6", state_dim=64, lora_dim=64,
                  decay_lora_dim=64),
    tie_embeddings=False,
    max_seq_len=1048576,
    source="arXiv:2404.05892",
)
