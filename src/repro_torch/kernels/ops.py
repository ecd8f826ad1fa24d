"""Kernel registry: the kernel families' native platforms, per-shape launch
choices with decision provenance, and the public paged-decode wrappers.

Port of the registry half of :mod:`repro.kernels.ops`:

  * :data:`NATIVE_PLATFORMS` — per family, the platforms (tensor device
    types) its kernel runs natively on, from each kernel module's
    ``LOWERS_ON``.  Only ``paged`` has a kernel in this port so far
    (``("cuda",)``); the planner (``core.mechanism.kernel_native``) keys
    kernel preference on this table.
  * :class:`KernelChoice` / :data:`CANDIDATES` / :class:`KernelRegistry`
    — the launch configuration per (family, shape), an explicit override
    winning, else the family's default, cached per shape and recorded in
    ``registry.decisions`` with its source (``"override"`` /
    ``"default"``).  Timed autotuning of the candidates on the card is
    later work.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.kernels import paged as kpaged

NATIVE_PLATFORMS: Dict[str, Tuple[str, ...]] = {
    "inhibitor": (),          # blockwise flash inhibitor: not ported yet
    "flash": (),              # blockwise flash attention: not ported yet
    "paged": tuple(kpaged.LOWERS_ON),
    "wkv6": (),               # RWKV-6 WKV scan: not ported yet
}


@dataclasses.dataclass(frozen=True)
class KernelChoice:
    """Launch configuration for one kernel call; ``None`` fields fall back
    to the registry's choice.  The paged kernels read ``pages_per_step``
    (pages staged in shared memory per round)."""
    block_q: Optional[int] = None
    block_k: Optional[int] = None
    sub_k: Optional[int] = None
    pages_per_step: Optional[int] = None

    def merge_onto(self, base: "KernelChoice") -> "KernelChoice":
        return KernelChoice(
            self.block_q if self.block_q is not None else base.block_q,
            self.block_k if self.block_k is not None else base.block_k,
            self.sub_k if self.sub_k is not None else base.sub_k,
            (self.pages_per_step if self.pages_per_step is not None
             else base.pages_per_step))

    @property
    def empty(self) -> bool:
        return self == KernelChoice()


#: Candidate launch configurations per family — the first is the default.
CANDIDATES: Dict[str, Tuple[KernelChoice, ...]] = {
    "paged": (
        KernelChoice(pages_per_step=kpaged.DEFAULT_PAGES_PER_STEP),
        KernelChoice(pages_per_step=1), KernelChoice(pages_per_step=2),
        KernelChoice(pages_per_step=8),
    ),
}


class KernelRegistry:
    """Per-(family, shape) launch choices and their provenance."""

    def __init__(self):
        self.tuned: Dict[tuple, KernelChoice] = {}
        # (family,) + shape_key -> {"choice", "source", "platform", "native"}
        self.decisions: Dict[tuple, dict] = {}

    def reset(self) -> None:
        self.tuned.clear()
        self.decisions.clear()

    def choose(self, family: str, shape_key: tuple, platform: str,
               override: Optional[KernelChoice] = None) -> KernelChoice:
        """Resolve the launch configuration for ``family`` at ``shape_key``
        on ``platform``: a non-empty ``override`` wins (its ``None``
        fields filled from the cached choice), else the cached choice,
        else the family default."""
        key = (family,) + shape_key
        base = self.tuned.setdefault(key, CANDIDATES[family][0])
        if override is not None and not override.empty:
            choice, source = override.merge_onto(base), "override"
        else:
            choice, source = base, "default"
        self.decisions[key] = {
            "choice": choice, "source": source, "platform": platform,
            "native": platform in NATIVE_PLATFORMS.get(family, ())}
        return choice


registry = KernelRegistry()


def _paged_choice(family_key: str, q, k_pool, block_tables,
                  override: Optional[KernelChoice]) -> KernelChoice:
    shape_key = (family_key, block_tables.shape[1], k_pool.shape[1],
                 q.shape[2], k_pool.shape[2], q.shape[3])
    return registry.choose("paged", shape_key, q.device.type, override)


def paged_flash_inhibitor(q, k_pool, v_pool, block_tables, lengths, *,
                          score_scale=None, score_shift=0.5, signed=True,
                          normalize=True, window=None, choice=None):
    """Block-table-native paged inhibitor decode (inference only)."""
    c = _paged_choice("inhibitor", q, k_pool, block_tables, choice)
    return kpaged.paged_flash_inhibitor_fwd(
        q, k_pool, v_pool, block_tables, lengths, score_scale=score_scale,
        score_shift=score_shift, signed=signed, normalize=normalize,
        window=window, pages_per_step=c.pages_per_step)


def paged_flash_attention(q, k_pool, v_pool, block_tables, lengths, *,
                          score_scale=None, window=None, choice=None):
    """Block-table-native paged Softmax decode (inference only)."""
    c = _paged_choice("flash", q, k_pool, block_tables, choice)
    return kpaged.paged_flash_attention_fwd(
        q, k_pool, v_pool, block_tables, lengths, score_scale=score_scale,
        window=window, pages_per_step=c.pages_per_step)
