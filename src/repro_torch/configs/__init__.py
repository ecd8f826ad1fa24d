"""Architecture registry: ``--arch <id>`` resolution for the port.

``get_config(name)`` resolves ids with or without the attention override
suffix (``smollm-135m@inhibitor``, ``@inhibitor_unsigned``, ``@dotprod``).
The port carries every config of the reference: the dense
``smollm-135m``, ``qwen2-0.5b``, ``qwen1.5-4b``, ``stablelm-1.6b`` and
``paper-tiny``, the MoE ``qwen2-moe-a2.7b`` and ``llama4-scout-17b-a16e``,
the hybrid ``hymba-1.5b``, the encoder-decoder ``seamless-m4t-large-v2``,
the vlm ``llava-next-mistral-7b`` and the RWKV-6 ``rwkv6-7b`` (family
``ssm``), which is attention-free: any attention kind but ``dotprod`` is
rejected, as in the reference.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    SHAPES, SHAPES_BY_NAME, EncDecConfig, FrontendConfig, ModelConfig,
    MoEConfig, ShapeConfig, SSMConfig)

_MODULES = {
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_16e",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
    "paper-tiny": "repro_torch.configs.paper_tiny",
}

ARCH_IDS = tuple(k for k in _MODULES if k != "paper-tiny")

# archs whose attention is replaceable by the paper's mechanism
INHIBITOR_APPLICABLE = tuple(a for a in ARCH_IDS if a != "rwkv6-7b")

# sub-quadratic archs eligible for the long_500k shape
LONG_CONTEXT_ARCHS = ("rwkv6-7b", "hymba-1.5b")


def get_config(name: str) -> ModelConfig:
    """Resolve an arch id, optionally suffixed ``@<attention_kind>``."""
    kind = None
    if "@" in name:
        name, kind = name.split("@", 1)
    if name not in _MODULES:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_MODULES)}")
    cfg = importlib.import_module(_MODULES[name]).CONFIG
    if kind is not None:
        if name == "rwkv6-7b" and kind != "dotprod":
            raise ValueError(
                "rwkv6-7b is attention-free; the inhibitor mechanism is "
                "inapplicable")
        cfg = cfg.with_attention_kind(kind)
    return cfg
