"""The comparisons that decide ``correct``, and their readings.

Training (the first ``check_steps`` steps, which the window's own call and
feed make during set-up):

* ``loss_gap``: the widest gap between the program's loss and the
  reference's over those steps;
* ``grad_gap``: the first gradient as the optimizer got it (its first
  moment after one step over 1 - b1, so after the clip), by the worst
  leaf: | |g_program| - |g_reference| | over the larger of the
  reference's norm of that leaf and of the median leaf;
* ``change_gap``: the same of each parameter's change over the steps.

Leaves whose reference gradient is under a thousandth of the median
leaf's move under Adam by round-off alone, and are left out of both.

Serving: ``logit_gap``, the widest gap by which a served token's logit
lies below the reference's best at its position, over a sample of the
finished requests drawn from the seed (with the longest in it).  Each
number fails at or above its limit, from the configuration file.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import torch

# leaves whose reference gradient norm is under this share of the median
# leaf's take no part in the gradient and change readings
NEGLIGIBLE = 1e-3


def worst_leaf(program: List[float], reference: List[float],
               keep: List[bool]) -> float:
    """max over kept leaves of |p - r| / max(r, median r)."""
    med = statistics.median(r for r, k in zip(reference, keep) if k)
    return max(abs(p - r) / max(r, med)
               for p, r, k in zip(program, reference, keep) if k)


def train_readings(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` / ``ref``: {"losses": [...], "grad_norms": [...],
    "change_norms": [...]}, leaves in one order."""
    med = statistics.median(ref["grad_norms"])
    keep = [g >= NEGLIGIBLE * med for g in ref["grad_norms"]]
    return {
        "loss_gap": max(abs(a - b) for a, b in zip(prog["losses"],
                                                   ref["losses"])),
        "grad_gap": worst_leaf(prog["grad_norms"], ref["grad_norms"], keep),
        "change_gap": worst_leaf(prog["change_norms"], ref["change_norms"],
                                 keep),
    }


@torch.no_grad()
def served_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """ref_logits (n, V) at the positions that produced ``tokens`` (n,):
    the widest gap below each position's best."""
    best = ref_logits.max(-1).values
    got = ref_logits.gather(-1, tokens.long()[:, None])[:, 0]
    return float((best - got).max())


def verdict(readings: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every reading below its
    limit, and finite."""
    shown = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] == v["value"] and v["value"] < v["limit"]
             for v in shown.values())
    return ok, shown


def sample_requests(finished: List, seed: int, min_tokens: int,
                    max_requests: int, min_requests: int = 1) -> List:
    """The longest finished request, then others drawn from ``seed`` until
    ``min_requests`` requests and ``min_tokens`` served tokens, or
    ``max_requests`` requests."""
    import numpy as np

    if not finished:
        return []
    longest = max(finished, key=lambda r: (len(r.output), r.request_id))
    rest = [r for r in finished if r is not longest]
    order = np.random.default_rng([seed % 2 ** 63, 7]).permutation(len(rest))
    out, n = [longest], len(longest.output)
    for i in order:
        if (n >= min_tokens and len(out) >= min_requests) or \
                len(out) >= max_requests:
            break
        out.append(rest[i])
        n += len(rest[i].output)
    return out


def limits_of(model: dict, kind: str) -> Dict[str, float]:
    return dict(model["limits"][kind])


def finite(x: Optional[float]) -> bool:
    return x is not None and x == x and abs(x) != float("inf")
