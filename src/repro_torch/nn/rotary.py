"""Rotary position embeddings (RoPE, "rotate half" convention)."""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, base: float = 10000.0,
                     device=None) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies, float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (base ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               base: float = 10000.0) -> torch.Tensor:
    """Rotate ``x`` (batch, seq, heads, head_dim) at ``positions``
    (batch, seq) absolute positions."""
    inv_freq = rope_frequencies(x.shape[-1], base, device=x.device)
    angles = positions[..., None].float() * inv_freq       # (b, s, hd/2)
    sin = torch.sin(angles)[:, :, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
