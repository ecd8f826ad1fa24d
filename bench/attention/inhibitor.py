"""The reference's inhibitor attention (the paper's eq. 5 and 7), in
float32 PyTorch:

  Z_ij = ((1/sqrt(d)) sum_k |q_ik - k_jk| - alpha)^+
  H_ik = sum_j [(V+_jk - Z_ij)^+ + (V-_jk + Z_ij)^-]

over the causally attendable keys j <= i, divided by their count.  It is
computed in blocks of query rows, each over the keys it can attend, so
that its (rows, keys, head_dim) terms fit; under autograd each block is
recomputed in the backward (``torch.utils.checkpoint``).

``HOLDS`` is every value of the configuration's ``attention`` this module
implements; ``READS`` the keys it takes as they stand.
"""

from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

Q_BLOCK = 64

HOLDS = {"signed": True, "score_scale": "sqrt(head_dim)", "normalize": True,
         "causal": True, "sliding_window": None}
READS = {"score_shift"}


def _block(qb, kb, vb, q0: int, shift: float):
    """Queries at q0 .. q0 + rows - 1 over keys 0 .. n_k - 1, causal:
    (b, h, rows, d)."""
    d = qb.shape[-1]
    rows, n_k = qb.shape[2], kb.shape[2]
    z = torch.relu(torch.cdist(qb, kb, p=1) / math.sqrt(d) - shift)
    qi = q0 + torch.arange(rows, device=qb.device)[:, None]
    kj = torch.arange(n_k, device=qb.device)[None, :]
    allowed = kj <= qi                                          # (rows, n_k)
    z = torch.where(allowed, z, torch.inf)
    vp = torch.relu(vb)
    vn = vb - vp
    zc = z[..., None]                                   # (.., rows, n_k, 1)
    h = (torch.relu(vp[:, :, None] - zc)
         + torch.clamp(vn[:, :, None] + zc, max=0.0)).sum(-2)
    return h / allowed.sum(-1).to(h.dtype)[:, None]


def attend(q, k, v, attention: dict, *, q0: int = 0, block: int = Q_BLOCK):
    """q (b, n_q, h, d) at positions q0 + i; k, v (b, n_k, h_kv, d) at
    positions 0 .. n_k - 1 (n_k >= q0 + n_q).  Returns (b, n_q, h, d)."""
    h, hk = q.shape[2], k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).repeat_interleave(h // hk, dim=1)
    vt = v.transpose(1, 2).repeat_interleave(h // hk, dim=1)
    outs = []
    for lo in range(0, qt.shape[2], block):
        hi = min(lo + block, qt.shape[2])
        args = (qt[:, :, lo:hi], kt[:, :, :q0 + hi], vt[:, :, :q0 + hi],
                q0 + lo, attention["score_shift"])
        if torch.is_grad_enabled():
            outs.append(torch.utils.checkpoint.checkpoint(
                _block, *args, use_reentrant=False))
        else:
            outs.append(_block(*args))
    return torch.cat(outs, dim=2).transpose(1, 2)
