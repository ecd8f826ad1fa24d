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
    kernels under ``torch.autograd.Function``: the forward is the kernel;
    the inhibitor's backward is a kernel too
    (``kernels.inhibitor.flash_inhibitor_bwd``, its plain version the
    reference's analytic VJP), the Softmax's recomputes through the lean
    backward of :mod:`repro_torch.core` (as the reference's ``_fa_bwd``);
    an integer ``q_offset`` places the queries at ``q_offset + i`` of the
    keys' sequence (a ``model`` rank's query rows under sequence
    parallelism), forward and backward.  ``*_cached`` carry per-row
    decode cursors and are inference only.
  * :func:`wkv6` — the RWKV-6 WKV scan: from a zero state the kernel
    under ``torch.autograd.Function``, its backward the chunk-by-chunk
    autograd of :func:`repro_torch.nn.ssm.wkv6_chunked_vjp`; with a
    carried state the exact scan.
  * :class:`KernelChoice` / :data:`CANDIDATES` / :class:`KernelRegistry`
    — the launch configuration per (family, shape), recorded in
    ``registry.decisions`` with its source: an explicit override wins
    (``"override"``); on the card the paged kernels' candidates are timed
    (``"timed"``: one warm call, then the best of 3 by CUDA events, with
    concrete operands and outside a CUDA-graph capture) and the winner is
    cached per shape; without a timer the family default is used and not
    cached (``"default-trace"`` on the card, ``"default-cpu"`` on the
    CPU, where each wrapper runs its plain version).  Before timing, the
    cost model's static priors (``analysis.costmodel.
    rank_kernel_candidates``, recorded in ``registry.priors``) order the
    candidates cheapest first, and a candidate priced ``inf`` (refused by
    the kernel) is not timed unless every one is.  A cost-model error is
    not caught: it raises out of ``choose``.  Timing launches do not
    count in :func:`counts`.
  * :func:`counts` / :func:`add_counts` — each kernel's launches and each
    plain version's calls; a CUDA-graph replay adds the launches its
    capture recorded (``serve.engine``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Tuple

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
        # (family,) + shape_key -> [(KernelChoice, prior seconds), ...],
        # cheapest first: the cost model's ranking of each timed shape
        self.priors: Dict[tuple, list] = {}
        # (family,) + shape_key -> {"choice", "source", "platform", "native"}
        self.decisions: Dict[tuple, dict] = {}

    def reset(self) -> None:
        self.tuned.clear()
        self.priors.clear()
        self.decisions.clear()

    def choose(self, family: str, shape_key: tuple, platform: str,
               override: Optional[KernelChoice] = None,
               timer: Optional[Callable[[KernelChoice], float]] = None,
               ) -> KernelChoice:
        """Resolve the launch configuration for ``family`` at ``shape_key``
        on ``platform``.

        A non-empty ``override`` wins, its ``None`` fields filled from the
        tuned choice when there is one, else the default.  Else a tuned
        choice for the shape is returned.  Else, with a ``timer`` (one
        candidate -> seconds), the candidates are timed in the order of
        their static priors (:meth:`_ranked`; those priced ``inf`` are
        skipped unless all are), a candidate the kernel refuses
        (``ValueError``) dropping out, and the fastest (on a tie, the
        first timed) is cached and recorded as ``"timed"``.  Without a
        timer the default is returned and NOT cached, so a later call
        with concrete operands can still tune the shape."""
        candidates = CANDIDATES[family]
        default = candidates[0]
        key = (family,) + shape_key
        if override is not None and not override.empty:
            merged = override.merge_onto(self.tuned.get(key, default))
            self._record(family, key, merged, "override", platform)
            return merged
        hit = self.tuned.get(key)
        if hit is not None:
            return hit           # its decision was recorded when tuned
        if timer is None:
            if key not in self.decisions:
                self._record(family, key, default, "default-cpu"
                             if platform == "cpu" else "default-trace",
                             platform)
            return default
        ranked = self._ranked(family, shape_key, candidates)
        skip_inf = any(p != float("inf") for _, p in ranked)
        choice, best = default, float("inf")
        for cand, prior in ranked:
            if skip_inf and prior == float("inf"):
                continue
            try:
                t = timer(cand)
            except ValueError:   # refused by the wrapper's checks
                continue
            if t < best:
                choice, best = cand, t
        self.tuned[key] = choice
        self._record(family, key, choice, "timed", platform)
        return choice

    def _ranked(self, family: str, shape_key: tuple, candidates) -> list:
        """The candidates with their static priors, cheapest first
        (recorded in :attr:`priors`).  Unlike the reference, a cost-model
        error is not turned into declared order: it raises."""
        from repro_torch.analysis.costmodel import rank_kernel_candidates

        ranked = rank_kernel_candidates(family, shape_key, candidates)
        self.priors[(family,) + shape_key] = ranked
        return ranked

    def _record(self, family: str, key: tuple, choice: KernelChoice,
                source: str, platform: str) -> None:
        self.decisions[key] = {
            "choice": choice, "source": source, "platform": platform,
            "native": platform in NATIVE_PLATFORMS.get(family, ())}


registry = KernelRegistry()


@contextlib.contextmanager
def _uncounted():
    """Launches inside the block (timing runs) leave :func:`counts`
    as they were."""
    before = counts()
    try:
        yield
    finally:
        after = counts()
        add_counts({k: before[k] - after[k] for k in after})


def _timer(run: Callable[[KernelChoice], torch.Tensor]):
    """Seconds of one candidate on the card: one warm call, then the best
    of 3 calls, each between two CUDA events on the current stream."""
    def time_one(choice: KernelChoice) -> float:
        with _uncounted():
            run(choice)
            best = float("inf")
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run(choice)
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) * 1e-3)
        return best
    return time_one


def _local_only(*xs) -> None:
    """The kernels launch on raw device pointers (``kernels.cuda_lib``):
    a DTensor's local shard is not the tensor it stands for, so a DTensor
    raises rather than computing on one shard.  The sharded steps hand
    the model plain tensors (:mod:`repro_torch.launch.shardings`)."""
    from torch.distributed.tensor import DTensor

    for x in xs:
        if isinstance(x, DTensor):
            raise TypeError("a kernel wrapper got a DTensor "
                            f"{tuple(x.shape)} {x.placements}: the kernels "
                            "take plain (local) tensors")


def _paged_choice(family_key: str, q, k_pool, block_tables,
                  override: Optional[KernelChoice], run) -> KernelChoice:
    """The paged kernels' choice: timed on the card with concrete
    operands, never inside a CUDA-graph capture (timing synchronizes;
    the capture replays the choice its eager first run tuned)."""
    shape_key = (family_key, block_tables.shape[1], k_pool.shape[1],
                 q.shape[2], k_pool.shape[2], q.shape[3])
    timer = None
    if ((override is None or override.empty) and q.is_cuda
            and not torch.cuda.is_current_stream_capturing()):
        timer = _timer(run)
    return registry.choose("paged", shape_key, q.device.type, override,
                           timer)


def paged_flash_inhibitor(q, k_pool, v_pool, block_tables, lengths, *,
                          score_scale=None, score_shift=0.5, signed=True,
                          normalize=True, window=None, choice=None):
    """Block-table-native paged inhibitor decode (inference only)."""
    def run(c: KernelChoice):
        return kpaged.paged_flash_inhibitor_fwd(
            q, k_pool, v_pool, block_tables, lengths,
            score_scale=score_scale, score_shift=score_shift, signed=signed,
            normalize=normalize, window=window,
            pages_per_step=c.pages_per_step)

    _local_only(q, k_pool, v_pool)
    return run(_paged_choice("inhibitor", q, k_pool, block_tables, choice,
                             run))


def paged_flash_attention(q, k_pool, v_pool, block_tables, lengths, *,
                          score_scale=None, window=None, choice=None):
    """Block-table-native paged Softmax decode (inference only)."""
    def run(c: KernelChoice):
        return kpaged.paged_flash_attention_fwd(
            q, k_pool, v_pool, block_tables, lengths,
            score_scale=score_scale, window=window,
            pages_per_step=c.pages_per_step)

    _local_only(q, k_pool, v_pool)
    return run(_paged_choice("flash", q, k_pool, block_tables, choice, run))


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


def _offset(q_offset) -> int:
    """A training entry's query offset: a Python int (the rank's first
    query row of a sequence-parallel attention), never a tensor."""
    if isinstance(q_offset, bool) or not isinstance(q_offset, int) \
            or q_offset < 0:
        raise TypeError(f"q_offset must be an int >= 0, got {q_offset!r}")
    return q_offset


class _FlashInhibitor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, score_scale, score_shift, signed, normalize,
                causal, window, choice, q_offset):
        _prefill_choice("inhibitor", q, k, causal, window, False, choice)
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(score_scale=score_scale, score_shift=score_shift,
                      signed=signed, normalize=normalize)
        ctx.mask = (causal, window, q_offset)
        return kinhibitor.flash_inhibitor_fwd(
            q, k, v, causal=causal, window=window,
            q_offset=q_offset or None, **ctx.kw)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        causal, window, q_offset = ctx.mask
        with torch.profiler.record_function(BACKWARD_RANGE):
            grads = kinhibitor.flash_inhibitor_bwd(
                q, k, v, g, causal=causal, window=window, q_offset=q_offset,
                **ctx.kw)
        return grads + (None,) * 8


def flash_inhibitor(q, k, v, score_scale=None, score_shift=0.5, signed=True,
                    normalize=True, causal=True, window=None, choice=None,
                    q_offset: int = 0):
    """Flash-inhibitor attention with a recompute-based backward: the
    forward and the backward run their kernels (their plain versions on
    the CPU; the backward's is the reference's analytic VJP), and no score
    matrix is saved.  ``choice``
    (a :class:`KernelChoice`) overrides the registry's launch choice.
    ``q_offset`` (an int): the queries sit at positions ``q_offset + i``
    of the keys' sequence, every key valid (a ``model`` rank's query rows
    of a sequence-parallel attention); the causal / window structure
    moves with it, forward and backward."""
    _local_only(q, k, v)
    return _FlashInhibitor.apply(q, k, v, score_scale, score_shift, signed,
                                 normalize, causal, window, choice,
                                 _offset(q_offset))


def flash_inhibitor_cached(q, k, v, q_offset, kv_valid_len, *,
                           score_scale=None, score_shift=0.5, signed=True,
                           normalize=True, causal=True, window=None,
                           choice=None):
    """Decode-cache flash inhibitor: per-row ``q_offset`` /
    ``kv_valid_len`` cursors (ints, 0-d or (b,) tensors).  Inference only:
    no backward is defined for the cursor-carrying form."""
    _local_only(q, k, v)
    _prefill_choice("inhibitor", q, k, causal, window, True, choice)
    return kinhibitor.flash_inhibitor_fwd(
        q, k, v, score_scale=score_scale, score_shift=score_shift,
        signed=signed, normalize=normalize, causal=causal, window=window,
        q_offset=q_offset, kv_valid_len=kv_valid_len)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, score_scale, causal, window, choice, q_offset):
        c = _prefill_choice("flash", q, k, causal, window, False, choice)
        ctx.save_for_backward(q, k, v)
        ctx.cfg = (score_scale, causal, window, q_offset)
        return kflash.flash_attention_fwd(
            q, k, v, score_scale=score_scale, causal=causal, window=window,
            block_q=c.block_q, q_offset=q_offset or None)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.core.dotprod import dot_product_attention_vjp

        q, k, v = ctx.saved_tensors
        score_scale, causal, window, q_offset = ctx.cfg
        with torch.profiler.record_function(BACKWARD_RANGE):
            mask = kref.backward_mask(q, k, causal, window, q_offset)
            grads = dot_product_attention_vjp(q, k, v, g, mask=mask,
                                              score_scale=score_scale)
        return tuple(grads) + (None,) * 5


def flash_attention(q, k, v, score_scale=None, causal=True, window=None,
                    choice=None, q_offset: int = 0):
    """Flash (Softmax) attention with a recompute-based backward (see
    :func:`flash_inhibitor`, ``q_offset`` too)."""
    _local_only(q, k, v)
    return _FlashAttention.apply(q, k, v, score_scale, causal, window,
                                 choice, _offset(q_offset))


def flash_attention_cached(q, k, v, q_offset, kv_valid_len, *,
                           score_scale=None, causal=True, window=None,
                           choice=None):
    """Decode-cache flash attention (see :func:`flash_inhibitor_cached`)."""
    _local_only(q, k, v)
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
    _local_only(r, k, v, w, u)
    if state is not None:
        return kref.wkv6_ref(r, k, v, w, u, state)
    return _Wkv6.apply(r, k, v, w, u, chunk)


# ---------------------------------------------------------------------------
# launch / plain-call counts of every kernel
# ---------------------------------------------------------------------------

#: counts() key -> (function, attribute) holding it
_COUNTERS = {
    "paged_inhibitor": (kpaged.paged_flash_inhibitor_fwd, "launches"),
    "paged_attention": (kpaged.paged_flash_attention_fwd, "launches"),
    "paged_inhibitor_plain": (kpaged.paged_flash_inhibitor_plain, "calls"),
    "paged_attention_plain": (kpaged.paged_flash_attention_plain, "calls"),
    "flash_inhibitor": (kinhibitor.flash_inhibitor_fwd, "launches"),
    "flash_attention": (kflash.flash_attention_fwd, "launches"),
    "flash_inhibitor_plain": (kinhibitor.flash_inhibitor_plain, "calls"),
    "flash_inhibitor_bwd": (kinhibitor.flash_inhibitor_bwd, "launches"),
    "flash_inhibitor_bwd_plain": (kinhibitor.flash_inhibitor_bwd_plain,
                                  "calls"),
    "flash_attention_plain": (kflash.flash_attention_plain, "calls"),
    "wkv6": (kwkv6.wkv6_chunked, "launches"),
    "wkv6_plain": (kwkv6.wkv6_chunked_plain, "calls"),
}


def reset_counts() -> None:
    """Zero every kernel's launch count and every plain version's call
    count."""
    for fn, attr in _COUNTERS.values():
        setattr(fn, attr, 0)


def counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in
            _COUNTERS.items()}


def add_counts(delta: Dict[str, int]) -> None:
    """Add ``delta`` (a :func:`counts`-keyed dict) to the counts: a
    CUDA-graph replay adds the launches its capture recorded."""
    for name, n in delta.items():
        fn, attr = _COUNTERS[name]
        setattr(fn, attr, getattr(fn, attr) + n)
