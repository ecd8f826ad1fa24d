"""Carry parameters across from the JAX package.

:func:`params_from_jax` takes the reference's parameter tree — nested
dicts of numpy arrays, i.e. ``unbox(api.init(key))`` mapped through
``np.asarray`` — and returns the port's parameter dict: the same nesting
and leaf layouts, with the stacked ``("layers", …)`` axis of each layer
stack (``"blocks"``; the encoder-decoder's ``"encoder"`` and
``"decoder"``) split into a list of per-layer dicts.  Everything else
(``frontend_proj`` among it) is carried across unchanged.  Imports
nothing of JAX.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


def _map(tree: Any, fn: Callable[[np.ndarray], torch.Tensor]) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(np.asarray(tree))


def params_from_jax(tree: dict, cfg: ModelConfig, *, device=None) -> dict:
    """Reference parameter tree (numpy leaves) -> port parameters."""
    dev = resolve_device(device)

    def leaf(a: np.ndarray) -> torch.Tensor:
        if a.dtype.kind != "f":
            raise TypeError(f"expected a floating parameter, got {a.dtype}")
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    stacks = {"blocks": cfg.num_layers}
    if cfg.encdec is not None:
        stacks = {"encoder": cfg.encdec.encoder_layers,
                  "decoder": cfg.encdec.decoder_layers}
    out = {k: _map(v, leaf) for k, v in tree.items() if k not in stacks}
    for name, n in stacks.items():
        out[name] = [_map(tree[name], lambda a, i=i: leaf(a[i]))
                     for i in range(n)]
    return out
