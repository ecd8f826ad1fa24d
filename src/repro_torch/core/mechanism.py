"""Pluggable attention-mechanism registry + explicit backend planner.

Port of :mod:`repro.core.mechanism`.  A *mechanism* (Softmax dot-product,
the paper's Inhibitor, …) registers once with one callable per execution
*backend*; :func:`plan_attention` picks the backend for a call site's
:class:`AttnShapes` and returns an inspectable :class:`ExecutionPlan`;
:func:`execute_plan` runs it.

Backends implemented in this slice:

  ``naive``    broadcast oracle (large-Z / -1e9 masking)
  ``fused``    dense masked form (default)
  ``chunked``  streaming accumulation over KV chunks (inhibitor family)
  ``paged``    block-table gather over a paged KV pool, then ``fused``
               (prefill chunks; the CPU's decode)
  ``paged_pallas``  the block-table-native decode kernel — on CUDA the
               hand-written kernels of ``csrc/paged_decode.cu``
  ``blocked``  two-level chunk loop with structural masks and an analytic
               chunked backward (inhibitor family; ``core.blocked``)
  ``pallas``   the blockwise flash kernels (training forward, contiguous
               prefill) — on CUDA the hand-written kernels of
               ``csrc/flash_prefill.cu``, differentiable through the
               reference's backward (``kernels.ops``)

``int`` and ``fhe_sim`` stay registered under the reference's names, so
the planner returns the same plan as the reference for the same shapes,
but running one raises ``NotImplementedError`` naming the ROADMAP item
that ports it.

Selection order is the reference's (see :func:`plan_attention`); kernel
preference keys on :func:`kernel_native`, i.e. on the kernel modules'
``LOWERS_ON`` declarations (``inhibitor``, ``flash`` and ``paged`` lower
on ``"cuda"``).  ``AttnShapes.resolved_platform`` is the device type of
the call's tensors.
"""

from __future__ import annotations

import dataclasses
import logging
import warnings
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

log = logging.getLogger("repro_torch.plan")

BACKENDS: Tuple[str, ...] = (
    "naive", "fused", "chunked", "blocked", "pallas", "paged",
    "paged_pallas", "int", "fhe_sim")

#: Backends that consume a :class:`Structural` description and must never
#: be handed a materialized (n_q, n_k) mask array.
MASK_FREE_BACKENDS = frozenset({"blocked", "pallas", "paged_pallas"})

#: Backends that consume a page pool + :class:`PagedLayout`.
PAGED_BACKENDS = frozenset({"paged", "paged_pallas"})

DEFAULT_BLOCKED_THRESHOLD = 1 << 20
DEFAULT_CHUNKED_THRESHOLD = 4096


def default_platform() -> str:
    """Platform assumed when a call site names none: the CUDA card when
    one is present, else the CPU."""
    return "cuda" if torch.cuda.is_available() else "cpu"


class AttnShapes(NamedTuple):
    """Shape/placement facts the planner keys on.  ``platform`` is the
    device type of the call's tensors (``"cuda"`` / ``"cpu"``)."""
    batch: int
    n_q: int
    n_k: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    dtype: Any = torch.float32
    has_explicit_mask: bool = False
    is_cross: bool = False
    has_cache: bool = False
    scalar_cursor: bool = True
    platform: Optional[str] = None
    paged: bool = False

    @property
    def resolved_platform(self) -> str:
        return self.platform or default_platform()

    @property
    def score_elements(self) -> int:
        return self.n_q * self.n_k


@dataclasses.dataclass(frozen=True)
class Structural:
    """Mask structure for :data:`MASK_FREE_BACKENDS`, computed from indices
    inside the backend.  ``q_offset`` / ``kv_valid_len`` may be (b,)
    cursor tensors."""
    causal: bool = True
    window: Optional[int] = None
    q_offset: Any = 0
    kv_valid_len: Any = None


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Block-table layout for the paged backends: k/v arrive as page pools
    (num_pages, page_size, h_kv, d); ``block_tables`` (b, pages_per_slot)
    int32 maps each row's logical page to a physical page."""
    block_tables: Any
    page_size: int


@dataclasses.dataclass(frozen=True)
class MechanismParams:
    """Per-call mechanism hyper-parameters (``signed`` is fixed per
    mechanism through :attr:`Mechanism.param_overrides`)."""
    score_scale: Optional[float] = None
    score_shift: float = 0.0
    signed: bool = True
    normalize: bool = True
    kv_chunk: int = 256
    kernel_block_q: Optional[int] = None
    kernel_block_k: Optional[int] = None
    kernel_sub_k: Optional[int] = None
    kernel_pages_per_step: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """An inspectable dispatch decision."""
    mechanism: str
    backend: str
    reason: str

    def trace_line(self) -> str:
        return (f"plan: mechanism={self.mechanism} backend={self.backend} "
                f"reason={self.reason}")


BackendFn = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Mechanism:
    """One attention mechanism: semantics + its backend implementations.
    ``mask_semantics`` is ``"exclude"`` (masked pairs leave every sum —
    inhibitor family) or ``"neg_inf"`` (masked logits -> -inf)."""
    name: str
    description: str
    mask_semantics: str
    backends: Mapping[str, BackendFn]
    param_overrides: Mapping[str, Any] = dataclasses.field(
        default_factory=dict)

    def make_params(self, **kw) -> MechanismParams:
        kw.update(self.param_overrides)
        return MechanismParams(**kw)


_REGISTRY: Dict[str, Mechanism] = {}


def register_mechanism(mech: Mechanism, *,
                       overwrite: bool = False) -> Mechanism:
    unknown = set(mech.backends) - set(BACKENDS)
    if unknown:
        raise ValueError(
            f"mechanism {mech.name!r} declares unknown backends "
            f"{sorted(unknown)}; known: {BACKENDS}")
    if mech.name in _REGISTRY and not overwrite:
        raise ValueError(f"mechanism {mech.name!r} already registered "
                         f"(pass overwrite=True to replace)")
    _REGISTRY[mech.name] = mech
    return mech


def get_mechanism(name: str) -> Mechanism:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown attention mechanism {name!r}; registered: "
            f"{available_mechanisms()}") from None


def available_mechanisms() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _is_integer_dtype(dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex)


def backend_eligible(backend: str, cfg, shapes: AttnShapes,
                     mech: Mechanism) -> Tuple[bool, str]:
    """Can ``backend`` run this mechanism at these shapes?  (ok, why_not)."""
    if backend not in mech.backends:
        return False, f"not registered for mechanism {mech.name!r}"
    paged = getattr(shapes, "paged", False)
    if paged and backend not in PAGED_BACKENDS:
        return False, "KV lives in a paged pool (block-table backends only)"
    if backend in PAGED_BACKENDS:
        if not paged:
            return False, "no paged KV pool at this call site"
        if shapes.has_explicit_mask or shapes.is_cross:
            return False, "paged pools serve cached causal self-attention"
    if backend == "paged_pallas" and shapes.n_q != 1:
        return False, (f"paged decode kernel is single-query (n_q=1); "
                       f"n_q={shapes.n_q} prefill goes through the gather "
                       f"path")
    if backend == "paged_pallas":
        from repro_torch.kernels.paged import split_refusal

        why = split_refusal(kernel_family(mech.name),
                            shapes.num_heads // shapes.num_kv_heads,
                            shapes.head_dim)
        if why:
            return False, why
    is_int = _is_integer_dtype(shapes.dtype)
    if backend in ("int", "fhe_sim") and not is_int:
        return False, "requires integer-lane inputs"
    if backend not in ("int", "fhe_sim") and is_int:
        return False, "float backend on integer-lane inputs"
    if backend in MASK_FREE_BACKENDS:
        if shapes.has_explicit_mask:
            return False, "explicit mask array given (structural masks only)"
        if shapes.is_cross:
            return False, "cross-attention has no structural mask"
    if backend == "blocked" and not shapes.scalar_cursor:
        return False, "ragged per-slot cursors (no shared query offset)"
    if backend == "fhe_sim":
        if shapes.has_explicit_mask or shapes.is_cross or shapes.has_cache:
            return False, "circuit is self-attention without masking"
        if getattr(cfg, "causal", False) or getattr(cfg, "sliding_window",
                                                    None) is not None:
            return False, "circuit attends all-to-all (non-causal only)"
    return True, ""


def kernel_family(mechanism: str) -> str:
    """Kernel-registry family implementing ``mechanism``'s kernel path."""
    return ("inhibitor" if mechanism in ("inhibitor", "inhibitor_unsigned")
            else "flash")


def kernel_native(family: str, platform: str) -> bool:
    """True when ``family`` has a kernel that runs natively on
    ``platform`` (the kernel module's ``LOWERS_ON`` declaration, via
    ``kernels.ops.NATIVE_PLATFORMS``)."""
    from repro_torch.kernels.ops import NATIVE_PLATFORMS
    return platform in NATIVE_PLATFORMS.get(family, ())


_traced_plans: set = set()
_use_kernel_warned = False
_kind_warned = False


def _trace(plan: ExecutionPlan, shapes: Optional[AttnShapes] = None) -> None:
    """One-line plan trace, deduplicated per (mechanism, backend)."""
    key = (plan.mechanism, plan.backend)
    if key in _traced_plans:
        return
    _traced_plans.add(key)
    if shapes is not None:
        log.info("%s [n_q=%d n_k=%d heads=%d platform=%s]", plan.trace_line(),
                 shapes.n_q, shapes.n_k, shapes.num_heads,
                 shapes.resolved_platform)
    else:
        log.info("%s", plan.trace_line())


def resolve_mechanism_name(cfg) -> str:
    """``cfg.mechanism`` when set, else the deprecated ``cfg.kind`` (one
    ``DeprecationWarning`` per process), else ``"dotprod"``."""
    global _kind_warned
    name = getattr(cfg, "mechanism", None)
    if name:
        return name
    kind = getattr(cfg, "kind", None)
    if kind:
        if not _kind_warned:
            _kind_warned = True
            warnings.warn(
                "AttentionConfig.kind is deprecated; set mechanism="
                f"{kind!r} (the registry key) instead",
                DeprecationWarning, stacklevel=2)
        return kind
    return "dotprod"


def plan_attention(cfg, shapes: AttnShapes) -> ExecutionPlan:
    """The planner: explicit, inspectable backend selection.

    Selection order (first eligible wins), as in the reference:

      1. ``cfg.backend`` — forced; ineligibility is an error.
      2. ``cfg.use_kernel`` — deprecated shim for ``backend="pallas"``.
      3. ``paged_pallas`` where the paged kernel family runs natively and
         this is a single-query decode over a paged pool.
      4. ``paged`` for the remaining paged-pool sites (chunked prefill,
         hosts without the kernel).
      5. ``int`` for integer-lane inputs.
      6. ``pallas`` where its family runs natively, at large shapes.
      7. ``blocked`` at ``n_q·n_k ≥ cfg.blocked_threshold``.
      8. ``chunked`` when ``n_k > cfg.chunked_threshold``.
      9. ``fused``, else ``naive``.
    """
    global _use_kernel_warned
    name = resolve_mechanism_name(cfg)
    mech = get_mechanism(name)

    forced = getattr(cfg, "backend", None)
    shim_note = ""
    legacy_kernel_mechanism = name in ("inhibitor", "inhibitor_unsigned")
    if (forced is None and getattr(cfg, "use_kernel", False)
            and legacy_kernel_mechanism):
        if not _use_kernel_warned:
            _use_kernel_warned = True
            warnings.warn(
                "AttentionConfig.use_kernel is deprecated; set "
                "backend='pallas' (or leave backend=None for the planner)",
                DeprecationWarning, stacklevel=2)
        ok, why = backend_eligible("pallas", cfg, shapes, mech)
        if ok and not kernel_native(kernel_family(name),
                                    shapes.resolved_platform):
            ok, why = False, (f"host platform is "
                              f"{shapes.resolved_platform!r}, no native "
                              f"lowering — kernel would run in interpret "
                              f"mode")
        if ok:
            plan = ExecutionPlan(name, "pallas",
                                 "forced by config (use_kernel shim)")
            _trace(plan, shapes)
            return plan
        shim_note = f"use_kernel requested but pallas ineligible ({why}); "
    elif forced is not None:
        ok, why = backend_eligible(forced, cfg, shapes, mech)
        if not ok:
            raise ValueError(
                f"backend {forced!r} forced by config but ineligible for "
                f"mechanism {name!r} at {shapes!r}: {why}")
        plan = ExecutionPlan(name, forced, "forced by config")
        _trace(plan, shapes)
        return plan

    def eligible(b: str) -> bool:
        return backend_eligible(b, cfg, shapes, mech)[0]

    total = shapes.score_elements
    blocked_at = getattr(cfg, "blocked_threshold", DEFAULT_BLOCKED_THRESHOLD)
    chunked_at = getattr(cfg, "chunked_threshold", DEFAULT_CHUNKED_THRESHOLD)

    if (kernel_native("paged", shapes.resolved_platform)
            and eligible("paged_pallas")):
        plan = ExecutionPlan(
            name, "paged_pallas",
            shim_note + f"paged KV pool, single-query decode "
            f"(block-table-native kernel lowers natively on "
            f"{shapes.resolved_platform!r})")
    elif eligible("paged"):
        if getattr(shapes, "paged", False) and shapes.n_q != 1:
            why = f"chunked prefill n_q={shapes.n_q}"
        else:
            why = (f"no native paged-kernel lowering on "
                   f"{shapes.resolved_platform!r}; interpret-mode Pallas "
                   f"never outranks the gather")
        plan = ExecutionPlan(
            name, "paged",
            shim_note + f"paged KV pool (block-table gather: {why})")
    elif eligible("int"):
        plan = ExecutionPlan(name, "int", shim_note + "integer-lane inputs")
    elif (kernel_native(kernel_family(name), shapes.resolved_platform)
            and total >= blocked_at and eligible("pallas")):
        plan = ExecutionPlan(
            name, "pallas",
            shim_note + f"native pallas lowering on "
            f"{shapes.resolved_platform!r}, structural mask, "
            f"n_q*n_k={total} >= blocked_threshold={blocked_at}")
    elif total >= blocked_at and eligible("blocked"):
        plan = ExecutionPlan(
            name, "blocked",
            shim_note + f"structural mask and n_q*n_k={total} >= "
            f"blocked_threshold={blocked_at}")
    elif shapes.n_k > chunked_at and eligible("chunked"):
        plan = ExecutionPlan(
            name, "chunked",
            shim_note + f"n_k={shapes.n_k} > chunked_threshold={chunked_at}")
    elif eligible("fused"):
        plan = ExecutionPlan(name, "fused", shim_note + "dense default")
    elif eligible("naive"):
        plan = ExecutionPlan(name, "naive",
                             shim_note + "only the oracle backend is eligible")
    else:
        raise ValueError(
            f"no eligible backend for mechanism {name!r} at {shapes!r} "
            f"(registered: {sorted(mech.backends)})")
    _trace(plan, shapes)
    return plan


def choose_plan(mechanism: str, candidates) -> ExecutionPlan:
    """First-eligible-wins chooser for token mixers that take no (q, k, v)
    (the RWKV WKV scan).  ``candidates`` is an ordered iterable of
    ``(backend, eligible, reason)``; the chosen plan is trace-logged like
    :func:`plan_attention`'s."""
    for backend, ok, reason in candidates:
        if ok:
            plan = ExecutionPlan(mechanism, backend, reason)
            _trace(plan)
            return plan
    raise ValueError(f"no eligible backend among candidates for "
                     f"{mechanism!r}")


def execute_plan(plan: ExecutionPlan, q, k, v, *,
                 params: MechanismParams,
                 mask=None,
                 structural: Optional[Structural] = None,
                 paged: Optional[PagedLayout] = None) -> torch.Tensor:
    """Run ``plan`` on (q, k, v): q (b, n_q, h, d); k, v (b, n_k, h_kv, d),
    or page pools (num_pages, page_size, h_kv, d) plus ``paged`` for the
    paged backends.  Mask-free backends take ``structural`` instead of a
    mask; mixing the two fails loudly."""
    mech = get_mechanism(plan.mechanism)
    fn = mech.backends.get(plan.backend)
    if fn is None:
        raise ValueError(f"plan names backend {plan.backend!r} which is not "
                         f"registered for mechanism {plan.mechanism!r}")
    if plan.backend in MASK_FREE_BACKENDS and mask is not None:
        raise ValueError(f"backend {plan.backend!r} is mask-free; got an "
                         f"explicit mask array")
    if (paged is not None) != (plan.backend in PAGED_BACKENDS):
        raise ValueError(
            f"backend {plan.backend!r} and paged layout "
            f"{'given' if paged is not None else 'missing'} — paged pools "
            f"are only consumable by {sorted(PAGED_BACKENDS)}")
    if plan.backend in PAGED_BACKENDS:
        return fn(q, k, v, mask=mask, params=params, structural=structural,
                  paged=paged)
    return fn(q, k, v, mask=mask, params=params, structural=structural)


# ---------------------------------------------------------------------------
# Shared helpers for the builtin backends
# ---------------------------------------------------------------------------

def _to_heads(q, k, v):
    """(b, n, h|h_kv, d) -> GQA-repeated (b, h, n, d) triples."""
    from repro_torch.core.inhibitor import _repeat_kv

    rep = q.shape[2] // k.shape[2]
    return (q.transpose(1, 2), _repeat_kv(k, rep).transpose(1, 2),
            _repeat_kv(v, rep).transpose(1, 2))


def _not_ported(backend: str, roadmap: str) -> BackendFn:
    """A registered backend name whose implementation a later slice ports:
    running it raises, naming the ROADMAP item."""
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"backend {backend!r} is not ported to PyTorch yet ({roadmap})")
    return fn


_INT = _not_ported("int", "ROADMAP queue 1 item 2: integer lanes")
_FHE_SIM = _not_ported("fhe_sim", "ROADMAP queue 1 item 2: FHE simulator")


def _gather_pages(k_pool, v_pool, paged: PagedLayout):
    """Per-row contiguous KV views out of the page pools: (b, P*ps, h_kv,
    d).  Unmapped table entries point at trash page 0; those positions
    sit beyond the valid-length mask."""
    idx = paged.block_tables.long()
    kt, vt = k_pool[idx], v_pool[idx]          # (b, P, ps, h_kv, d)
    b, npg, ps, hk, d = kt.shape
    return (kt.reshape(b, npg * ps, hk, d), vt.reshape(b, npg * ps, hk, d))


def _paged_lengths(q, s: Structural) -> torch.Tensor:
    """Per-row valid-length cursors (b,) int32 for the paged kernels."""
    if s.kv_valid_len is None:
        raise ValueError(
            "paged_pallas needs per-row kv_valid_len cursors (the paged "
            "cache always carries them); got Structural(kv_valid_len=None)")
    lengths = torch.as_tensor(s.kv_valid_len, dtype=torch.int32,
                              device=q.device)
    return lengths.reshape(-1).expand(q.shape[0]).contiguous()


def _kernel_choice(params: MechanismParams):
    """Config block-size overrides -> a ``kernels.ops.KernelChoice`` (or
    None, leaving the choice to the kernel registry)."""
    if (params.kernel_block_q is None and params.kernel_block_k is None
            and params.kernel_sub_k is None
            and params.kernel_pages_per_step is None):
        return None
    from repro_torch.kernels.ops import KernelChoice

    return KernelChoice(params.kernel_block_q, params.kernel_block_k,
                        params.kernel_sub_k, params.kernel_pages_per_step)


# ---------------------------------------------------------------------------
# Builtin backends — inhibitor family
# ---------------------------------------------------------------------------

def _inhibitor_naive(q, k, v, *, mask=None, params, structural=None):
    """Broadcast oracle: eq. 5 scores, large-Z masking, eq. 6/7 inhibition."""
    from repro_torch.core import inhibitor as inh

    n_k = k.shape[1]
    qt, kt, vt = _to_heads(q, k, v)
    z = inh.manhattan_scores(qt, kt, score_scale=params.score_scale,
                             score_shift=params.score_shift)
    m = None
    if mask is not None:
        m = mask.expand(z.shape)
        z = inh.mask_scores(z, m)
    out = (inh.inhibit_signed_naive(vt, z) if params.signed
           else inh.inhibit_naive(vt, z))
    if params.normalize:
        if m is not None:
            cnt = m.float().sum(-1, keepdim=True)
            out = out / cnt.clamp(min=1.0)
        else:
            out = out / max(float(n_k), 1.0)
    return out.transpose(1, 2).to(q.dtype)


def _inhibitor_fused(q, k, v, *, mask=None, params, structural=None):
    from repro_torch.core import inhibitor as inh

    return inh.inhibitor_attention(
        q, k, v, mask=mask, score_scale=params.score_scale,
        score_shift=params.score_shift, signed=params.signed,
        normalize=params.normalize)


def _inhibitor_chunked(q, k, v, *, mask=None, params, structural=None):
    from repro_torch.core import inhibitor as inh

    return inh.inhibitor_attention_chunked(
        q, k, v, mask=mask, score_scale=params.score_scale,
        score_shift=params.score_shift, signed=params.signed,
        normalize=params.normalize, kv_chunk=params.kv_chunk)


def _inhibitor_blocked(q, k, v, *, mask=None, params, structural=None):
    from repro_torch.core.blocked import blocked_inhibitor_attention

    s = structural or Structural()
    return blocked_inhibitor_attention(
        q, k, v, score_scale=params.score_scale,
        score_shift=params.score_shift, signed=params.signed,
        normalize=params.normalize, causal=s.causal, window=s.window,
        q_offset=s.q_offset, kv_valid_len=s.kv_valid_len,
        chunk_k=params.kv_chunk, chunk_q=min(params.kv_chunk, 512))


def _structural_is_plain(s: Structural) -> bool:
    """True when the Structural carries no decode-cache cursors: the
    differentiable training kernel applies; otherwise the cursor-carrying
    (inference only) entry point."""
    return (s.kv_valid_len is None
            and isinstance(s.q_offset, int) and s.q_offset == 0)


def _inhibitor_pallas(q, k, v, *, mask=None, params, structural=None):
    from repro_torch.kernels import ops as kops

    s = structural or Structural()
    choice = _kernel_choice(params)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if _structural_is_plain(s):
        return kops.flash_inhibitor(q, k, v, params.score_scale,
                                    params.score_shift, params.signed,
                                    params.normalize, s.causal, s.window,
                                    choice)
    return kops.flash_inhibitor_cached(
        q, k, v, s.q_offset, s.kv_valid_len, score_scale=params.score_scale,
        score_shift=params.score_shift, signed=params.signed,
        normalize=params.normalize, causal=s.causal, window=s.window,
        choice=choice)


def _inhibitor_paged(q, k, v, *, mask=None, params, structural=None,
                     paged=None):
    kc, vc = _gather_pages(k, v, paged)
    return _inhibitor_fused(q, kc, vc, mask=mask, params=params)


def _inhibitor_paged_pallas(q, k, v, *, mask=None, params, structural=None,
                            paged=None):
    """Block-table-native decode: the kernel walks each row's table."""
    from repro_torch.kernels import ops as kops

    s = structural or Structural()
    return kops.paged_flash_inhibitor(
        q.contiguous(), k, v, paged.block_tables, _paged_lengths(q, s),
        score_scale=params.score_scale, score_shift=params.score_shift,
        signed=params.signed, normalize=params.normalize, window=s.window,
        choice=_kernel_choice(params))


# ---------------------------------------------------------------------------
# Builtin backends — dot-product (Softmax) family
# ---------------------------------------------------------------------------

def _dotprod_naive(q, k, v, *, mask=None, params, structural=None):
    """Plain Softmax oracle."""
    d = q.shape[-1]
    scale = (params.score_scale if params.score_scale is not None
             else float(d) ** 0.5)
    qt, kt, vt = _to_heads(q, k, v)
    logits = qt.float() @ kt.float().transpose(-1, -2) / scale
    if mask is not None:
        logits = torch.where(mask.expand(logits.shape), logits,
                             torch.full_like(logits, -1e9))
    out = torch.softmax(logits, dim=-1) @ vt.float()
    return out.transpose(1, 2).to(q.dtype)


def _dotprod_fused(q, k, v, *, mask=None, params, structural=None):
    from repro_torch.core import dotprod as dp

    return dp.dot_product_attention(q, k, v, mask=mask,
                                    score_scale=params.score_scale)


def _dotprod_pallas(q, k, v, *, mask=None, params, structural=None):
    from repro_torch.kernels import ops as kops

    s = structural or Structural()
    choice = _kernel_choice(params)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if _structural_is_plain(s):
        return kops.flash_attention(q, k, v, params.score_scale, s.causal,
                                    s.window, choice)
    return kops.flash_attention_cached(
        q, k, v, s.q_offset, s.kv_valid_len, score_scale=params.score_scale,
        causal=s.causal, window=s.window, choice=choice)


def _dotprod_paged(q, k, v, *, mask=None, params, structural=None,
                   paged=None):
    kc, vc = _gather_pages(k, v, paged)
    return _dotprod_fused(q, kc, vc, mask=mask, params=params)


def _dotprod_paged_pallas(q, k, v, *, mask=None, params, structural=None,
                          paged=None):
    from repro_torch.kernels import ops as kops

    s = structural or Structural()
    return kops.paged_flash_attention(
        q.contiguous(), k, v, paged.block_tables, _paged_lengths(q, s),
        score_scale=params.score_scale, window=s.window,
        choice=_kernel_choice(params))


# ---------------------------------------------------------------------------
# Builtin registrations
# ---------------------------------------------------------------------------

def _register_builtins() -> None:
    register_mechanism(Mechanism(
        name="dotprod",
        description="Scaled dot-product Softmax attention (paper eq. 3)",
        mask_semantics="neg_inf",
        backends={
            "naive": _dotprod_naive,
            "fused": _dotprod_fused,
            "pallas": _dotprod_pallas,
            "paged": _dotprod_paged,
            "paged_pallas": _dotprod_paged_pallas,
            "int": _INT,
            "fhe_sim": _FHE_SIM,
        },
    ))
    inhibitor_backends = {
        "naive": _inhibitor_naive,
        "fused": _inhibitor_fused,
        "chunked": _inhibitor_chunked,
        "blocked": _inhibitor_blocked,
        "pallas": _inhibitor_pallas,
        "paged": _inhibitor_paged,
        "paged_pallas": _inhibitor_paged_pallas,
        "int": _INT,
        "fhe_sim": _FHE_SIM,
    }
    register_mechanism(Mechanism(
        name="inhibitor",
        description="Signed inhibitor attention (paper eq. 7 / fused eq. 10)",
        mask_semantics="exclude",
        backends=dict(inhibitor_backends),
        param_overrides={"signed": True},
    ))
    register_mechanism(Mechanism(
        name="inhibitor_unsigned",
        description="Unsigned inhibitor attention (paper eq. 6 / fused eq. 9)",
        mask_semantics="exclude",
        backends=dict(inhibitor_backends),
        param_overrides={"signed": False},
    ))


_register_builtins()
