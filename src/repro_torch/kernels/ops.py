"""Kernel registry: the kernel families' native platforms, per-shape launch
choices with decision provenance, and the public kernel wrappers.

Port of :mod:`repro.kernels.ops`:

  * :data:`NATIVE_PLATFORMS` — per family, the platforms (tensor device
    types) its kernel runs natively on, from each kernel module's
    ``LOWERS_ON``: ``inhibitor``, ``flash``, ``paged`` and ``wkv6`` have
    CUDA kernels (``("cuda",)``); the planner (``core.mechanism.
    kernel_native``) and the RWKV model registry key kernel preference on
    this table.
  * :func:`flash_inhibitor` / :func:`flash_attention` — the training
    kernels under ``torch.autograd.Function``: the forward is the kernel,
    the backward recomputes through the reference (as the reference's
    ``_fi_bwd`` / ``_fa_bwd``): the analytic, key-chunked inhibitor
    backward and the lean Softmax backward of :mod:`repro_torch.core`.
    ``*_cached`` carry per-row decode cursors and are inference only.
  * :func:`wkv6` — the RWKV-6 WKV scan: from a zero state the kernel
    under ``torch.autograd.Function``, its backward the chunk-by-chunk
    autograd of :func:`repro_torch.nn.ssm.wkv6_chunked_vjp`; with a
    carried state the exact scan.
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

import torch

from repro_torch.kernels import flash as kflash
from repro_torch.kernels import inhibitor as kinhibitor
from repro_torch.kernels import paged as kpaged
from repro_torch.kernels import ref as kref
from repro_torch.kernels import rwkv6 as kwkv6

NATIVE_PLATFORMS: Dict[str, Tuple[str, ...]] = {
    "inhibitor": tuple(kinhibitor.LOWERS_ON),
    "flash": tuple(kflash.LOWERS_ON),
    "paged": tuple(kpaged.LOWERS_ON),
    "wkv6": tuple(kwkv6.LOWERS_ON),
}


@dataclasses.dataclass(frozen=True)
class KernelChoice:
    """Launch configuration for one kernel call; ``None`` fields fall back
    to the registry's choice.  The prefill kernels fix their key tile at
    64 (``kinhibitor.BLOCK_K``, ``kflash.BLOCK_K``).  The Softmax reads
    ``block_q`` (the query tile): in ``kflash.BLOCK_QS`` only on the
    tensor cores (bf16), any tile in float32, halved to fit.  The
    inhibitor ignores ``block_q``: its query tile is fixed at
    ``kinhibitor.BLOCK_Q``.  The paged
    kernels read ``pages_per_step``: the pages per split (one block
    each), for the inhibitor and the Softmax alike."""
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
    "inhibitor": (KernelChoice(block_k=kinhibitor.BLOCK_K),),
    "flash": tuple(KernelChoice(bq, kflash.BLOCK_K)
                   for bq in kflash.BLOCK_QS),
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


# ---------------------------------------------------------------------------
# blockwise prefill / training kernels
# ---------------------------------------------------------------------------

#: profiler range around the training kernels' backward recompute (read
#: by ``launch.profile --train``)
BACKWARD_RANGE = "repro_torch.flash_backward"

_KEY_TILE = {"inhibitor": kinhibitor.BLOCK_K, "flash": kflash.BLOCK_K}


def _prefill_choice(family: str, q, k, causal, window, cached: bool,
                    override: Optional[KernelChoice]) -> KernelChoice:
    shape_key = (q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3],
                 causal, window, cached)
    c = registry.choose(family, shape_key, q.device.type, override)
    key_tile = _KEY_TILE[family]
    if c.block_k not in (None, key_tile):
        raise ValueError(f"the {family} kernel stages {key_tile} keys per "
                         f"tile; block_k={c.block_k} is not a launch option")
    return c


class _FlashInhibitor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, score_scale, score_shift, signed, normalize,
                causal, window, choice):
        _prefill_choice("inhibitor", q, k, causal, window, False, choice)
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(score_scale=score_scale, score_shift=score_shift,
                      signed=signed, normalize=normalize)
        ctx.mask = (causal, window)
        return kinhibitor.flash_inhibitor_fwd(
            q, k, v, causal=causal, window=window, **ctx.kw)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.core.inhibitor import inhibitor_attention_vjp

        q, k, v = ctx.saved_tensors
        with torch.profiler.record_function(BACKWARD_RANGE):
            mask = kref._mask_for(q.shape[1], k.shape[1], *ctx.mask,
                                  q.device)
            grads = inhibitor_attention_vjp(q, k, v, g, mask=mask, **ctx.kw)
        return grads + (None,) * 7


def flash_inhibitor(q, k, v, score_scale=None, score_shift=0.5, signed=True,
                    normalize=True, causal=True, window=None, choice=None):
    """Flash-inhibitor attention with a recompute-based backward: the
    forward runs the kernel (its plain version on the CPU), the backward
    the reference's analytic VJP (no score matrix is saved).  ``choice``
    (a :class:`KernelChoice`) overrides the registry's launch choice."""
    return _FlashInhibitor.apply(q, k, v, score_scale, score_shift, signed,
                                 normalize, causal, window, choice)


def flash_inhibitor_cached(q, k, v, q_offset, kv_valid_len, *,
                           score_scale=None, score_shift=0.5, signed=True,
                           normalize=True, causal=True, window=None,
                           choice=None):
    """Decode-cache flash inhibitor: per-row ``q_offset`` /
    ``kv_valid_len`` cursors (ints, 0-d or (b,) tensors).  Inference only:
    no backward is defined for the cursor-carrying form."""
    _prefill_choice("inhibitor", q, k, causal, window, True, choice)
    return kinhibitor.flash_inhibitor_fwd(
        q, k, v, score_scale=score_scale, score_shift=score_shift,
        signed=signed, normalize=normalize, causal=causal, window=window,
        q_offset=q_offset, kv_valid_len=kv_valid_len)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, score_scale, causal, window, choice):
        c = _prefill_choice("flash", q, k, causal, window, False, choice)
        ctx.save_for_backward(q, k, v)
        ctx.cfg = (score_scale, causal, window)
        return kflash.flash_attention_fwd(
            q, k, v, score_scale=score_scale, causal=causal, window=window,
            block_q=c.block_q)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.core.dotprod import dot_product_attention_vjp

        q, k, v = ctx.saved_tensors
        score_scale, causal, window = ctx.cfg
        with torch.profiler.record_function(BACKWARD_RANGE):
            mask = kref._mask_for(q.shape[1], k.shape[1], causal, window,
                                  q.device)
            grads = dot_product_attention_vjp(q, k, v, g, mask=mask,
                                              score_scale=score_scale)
        return tuple(grads) + (None,) * 4


def flash_attention(q, k, v, score_scale=None, causal=True, window=None,
                    choice=None):
    """Flash (Softmax) attention with a recompute-based backward (see
    :func:`flash_inhibitor`)."""
    return _FlashAttention.apply(q, k, v, score_scale, causal, window,
                                 choice)


def flash_attention_cached(q, k, v, q_offset, kv_valid_len, *,
                           score_scale=None, causal=True, window=None,
                           choice=None):
    """Decode-cache flash attention (see :func:`flash_inhibitor_cached`)."""
    c = _prefill_choice("flash", q, k, causal, window, True, choice)
    return kflash.flash_attention_fwd(
        q, k, v, score_scale=score_scale, causal=causal, window=window,
        block_q=c.block_q, q_offset=q_offset, kv_valid_len=kv_valid_len)


# ---------------------------------------------------------------------------
# RWKV-6 WKV
# ---------------------------------------------------------------------------

#: profiler range around the WKV kernel's backward (read by
#: ``launch.profile --train``)
WKV6_BACKWARD_RANGE = "repro_torch.wkv6_backward"


class _Wkv6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u)
        ctx.chunk = chunk
        return kwkv6.wkv6_chunked(r, k, v, w, u, chunk=chunk)

    @staticmethod
    def backward(ctx, g_out, g_state):
        from repro_torch.nn.ssm import wkv6_chunked_vjp

        r, k, v, w, u = ctx.saved_tensors
        with torch.profiler.record_function(WKV6_BACKWARD_RANGE):
            grads = wkv6_chunked_vjp(r, k, v, w, u, g_out, g_state,
                                     chunk=ctx.chunk)
        return grads + (None,)


def wkv6(r, k, v, w, u, state=None, *, chunk: int = kwkv6.DEFAULT_CHUNK):
    """Chunked WKV6 (the kernel; its plain version on the CPU) from a zero
    state, differentiable through the chunked form's backward; the exact
    scan when a carried state is given.  The kernel-vs-scan plan is made
    (and trace-logged) at the model level — ``models.rwkv.wkv_plan`` — so
    this wrapper only enforces the state-carry constraint.  Returns (out (b, t, h, n), final state (b, h, n, n)),
    float32."""
    if state is not None:
        return kref.wkv6_ref(r, k, v, w, u, state)
    return _Wkv6.apply(r, k, v, w, u, chunk)


# ---------------------------------------------------------------------------
# launch / plain-call counts of every kernel
# ---------------------------------------------------------------------------

def reset_counts() -> None:
    """Zero every kernel's launch count and every plain version's call
    count."""
    kpaged.reset_counts()
    kinhibitor.flash_inhibitor_fwd.launches = 0
    kflash.flash_attention_fwd.launches = 0
    kinhibitor.flash_inhibitor_plain.calls = 0
    kflash.flash_attention_plain.calls = 0
    kwkv6.wkv6_chunked.launches = 0
    kwkv6.wkv6_chunked_plain.calls = 0


def counts() -> dict:
    return {
        **kpaged.counts(),
        "flash_inhibitor": kinhibitor.flash_inhibitor_fwd.launches,
        "flash_attention": kflash.flash_attention_fwd.launches,
        "flash_inhibitor_plain": kinhibitor.flash_inhibitor_plain.calls,
        "flash_attention_plain": kflash.flash_attention_plain.calls,
        "wkv6": kwkv6.wkv6_chunked.launches,
        "wkv6_plain": kwkv6.wkv6_chunked_plain.calls,
    }
