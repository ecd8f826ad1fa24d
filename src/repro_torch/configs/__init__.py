"""Architecture registry: ``--arch <id>`` resolution for the port.

``get_config(name)`` resolves ids with or without the attention override
suffix (``smollm-135m@inhibitor``, ``@inhibitor_unsigned``, ``@dotprod``).
The port carries the dense configs ``smollm-135m`` and ``paper-tiny``
and the RWKV-6 config ``rwkv6-7b`` (family ``ssm``), which is
attention-free: any attention kind but ``dotprod`` is rejected, as in the
reference.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, SSMConfig  # noqa: F401

_MODULES = {
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "paper-tiny": "repro_torch.configs.paper_tiny",
}

ARCH_IDS = tuple(k for k in _MODULES if k != "paper-tiny")


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
