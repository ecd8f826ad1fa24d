"""Numeric execution lanes: one op set, three arithmetic domains.

Port of :mod:`repro.core.lanes`.  A :class:`Lane` exposes exactly the op
vocabulary TFHE executes cheaply — ciphertext add/sub, plaintext-weight
matmul (levelled), multiply/shift by literals, univariate table lookups
(1 PBS each) — and the nn layers, attention mechanisms and model forward
are written once against it (DESIGN.md §9).

Three lanes implement the protocol, each on an explicit ``device`` (the
card unless the caller names the CPU; a lane never moves its work
elsewhere on its own):

  * :class:`FloatLane`   — torch float32.  Literal shifts divide exactly
    and LUT sites apply their *real-valued* counterpart (``float_fn``).
  * :class:`IntLane`     — torch int32 with jnp's int32 semantics: every
    op ends in int32 and wraps modulo 2^32 (torch widens sums and mixed
    products to int64; the lane narrows them back).  LUTs are tables
    built by the same numpy table functions the FHE lane uses, so its
    results are bit-exact with ``fhe_sim``.
  * :class:`FheSimLane`  — torch int64 over a shared
    :class:`~repro_torch.fhe.tfhe_sim.FheContext`: identical integer
    arithmetic plus per-op cost accounting (PBS / cmul / add / lit-mul
    and the message-width high-water marks parameter selection keys on).
    ``lane.scope(name)`` attributes costs per layer.

Integer matrix products go through :func:`exact_int_matmul`: CUDA has no
integer matmul, so on the card it multiplies in float64, which is exact
while every partial sum stays below 2^53 — a bound it checks before the
product and raises on, never falling back.

Domain convention: every generic LUT declares its input domain
``[lo, hi]`` and *saturates* into it; the bit-width recorded at the PBS
is the width of the saturated input.

Ciphertext×ciphertext multiplication (:meth:`Lane.mul` and the two
contraction helpers) exists on every lane — the dot-product baseline
needs it — but the inhibitor family never calls it, which is exactly the
zero-``cmuls`` line in the full-block cost report.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

Handle = Any   # lane-private tensor handle (a torch tensor)

#: float64 represents every integer below 2^53 exactly
_F64_EXACT = 1 << 53

#: the largest max|a|·max|b|·K the float64 products (the card's branch of
#: :func:`exact_int_matmul`) checked since :func:`reset_matmul_bound`, and
#: how many products they ran
_MATMUL_BOUND = {"max_bound": 0, "calls": 0}


def reset_matmul_bound() -> None:
    _MATMUL_BOUND.update(max_bound=0, calls=0)


def matmul_bound() -> dict:
    """``{"max_bound", "calls"}`` of the float64 products since the last
    :func:`reset_matmul_bound` (``max_bound`` against 2^53)."""
    return dict(_MATMUL_BOUND)


def _abs_max(t: torch.Tensor) -> int:
    """max |t| as a Python int: one reduction, one host read."""
    if t.numel() == 0:
        return 0
    lo, hi = (int(x) for x in torch.stack(torch.aminmax(t)).tolist())
    return max(hi, -lo)


def exact_int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul`` of two integer tensors, exact, as int64.

    On the CPU: torch's int64 matmul.  On CUDA (no integer matmul): the
    float64 product, exact when max|a|·max|b|·K < 2^53 — checked with one
    reduction per operand before the product; a product beyond the bound
    raises ``ValueError``.
    """
    if a.device.type == "cpu":
        return torch.matmul(a.long(), b.long())
    return _float64_matmul(a, b)


def _float64_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The float64 branch of :func:`exact_int_matmul` (any device)."""
    k = a.shape[-1]
    bound = _abs_max(a) * _abs_max(b) * k
    _MATMUL_BOUND["max_bound"] = max(_MATMUL_BOUND["max_bound"], bound)
    _MATMUL_BOUND["calls"] += 1
    if bound >= _F64_EXACT:
        raise ValueError(
            f"integer matmul bound max|a|*max|b|*K = {bound} >= 2^53: the "
            f"float64 product on {a.device.type} would not be exact")
    return torch.matmul(a.double(), b.double()).long()


def _host(x) -> np.ndarray:
    """A cleartext operand (tokens, table) as numpy on the host."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _lookup(t: torch.Tensor, fn: Callable[[np.ndarray], np.ndarray],
            lo: int, hi: int, dtype: torch.dtype) -> torch.Tensor:
    """``fn`` applied elementwise to ``t`` (already in [lo, hi]) as a
    table: ``fn`` over the whole domain in numpy int64, narrowed to
    ``dtype`` (wrapping, as numpy's astype does), moved to ``t``'s device
    once and gathered by ``t − lo``."""
    vals = np.asarray(fn(np.arange(lo, hi + 1, dtype=np.int64)),
                      dtype=np.int64)
    if dtype == torch.int32:
        vals = vals.astype(np.int32)
    table = torch.from_numpy(vals).to(t.device)
    return table[(t - lo).long()]


class Lane:
    """Protocol + shared derived ops.  Concrete lanes implement the
    primitive set; everything else (``lut2``) is written once here."""

    name: str = "?"
    is_float: bool = False
    #: FHE cost context (None on plaintext lanes)
    ctx = None
    device: torch.device

    # ---- ingest / export -------------------------------------------------
    def array(self, x) -> Handle:
        raise NotImplementedError

    def embed(self, table: np.ndarray, tokens) -> Handle:
        """Client-side embedding ingest: cleartext table row gather on
        cleartext token ids (on the host), then :meth:`array`."""
        return self.array(_host(table)[_host(tokens)])

    def to_numpy(self, t: Handle) -> np.ndarray:
        return t.detach().cpu().numpy().copy()

    def shape(self, t: Handle):
        return tuple(t.shape)

    def _lit(self, b):
        """A literal operand: a Python int as is (torch keeps the
        handle's dtype for it), anything else through :meth:`array`."""
        return b if isinstance(b, int) else self.array(b)

    def _mask(self, mask) -> torch.Tensor:
        """A cleartext mask (numpy or torch bool) on the lane's device."""
        return torch.as_tensor(mask, dtype=torch.bool, device=self.device)

    # ---- structure (free: wire relabeling, no homomorphic work) ----------
    def reshape(self, t: Handle, shape) -> Handle:
        return t.reshape(shape)

    def transpose(self, t: Handle, axes) -> Handle:
        return t.permute(axes)

    def expand_dims(self, t: Handle, axis: int) -> Handle:
        return t.unsqueeze(axis)

    def repeat(self, t: Handle, rep: int, axis: int) -> Handle:
        return torch.repeat_interleave(t, rep, dim=axis)

    # ---- levelled ops ----------------------------------------------------
    def add(self, a: Handle, b) -> Handle:
        raise NotImplementedError

    def sub(self, a: Handle, b) -> Handle:
        raise NotImplementedError

    def neg(self, t: Handle) -> Handle:
        return -t

    def mul_literal(self, t: Handle, c) -> Handle:
        """Multiply by a cleartext integer scalar/array (levelled)."""
        raise NotImplementedError

    def shift_right(self, t: Handle, k: int) -> Handle:
        """Arithmetic shift by a static amount (divide by 2^k)."""
        raise NotImplementedError

    def matmul_plain(self, t: Handle, w: np.ndarray) -> Handle:
        """(..., d_in) × cleartext (d_in, d_out) — the levelled
        plaintext-weight matmul every projection/MLP/logit layer uses."""
        raise NotImplementedError

    def sum(self, t: Handle, axis, keepdims: bool = False) -> Handle:
        raise NotImplementedError

    def select(self, mask, t: Handle, fill: int) -> Handle:
        """Cleartext-mask select: keep ``t`` where mask, else the literal
        ``fill`` (one literal multiply per element)."""
        raise NotImplementedError

    def clip(self, t: Handle, lo: int, hi: int) -> Handle:
        """Declared-range saturation (the quantized activation clamp);
        free — it is absorbed into the next table's domain."""
        return torch.clamp(t, lo, hi)

    # ---- PBS ops ---------------------------------------------------------
    def relu(self, t: Handle) -> Handle:
        raise NotImplementedError

    def abs(self, t: Handle) -> Handle:
        raise NotImplementedError

    def max(self, t: Handle, axis: int, keepdims: bool = False) -> Handle:
        """Row max via the relu-tree (``max(a,b) = b + relu(a−b)``):
        ~1 PBS per element on the FHE lane."""
        raise NotImplementedError

    def masked_max(self, t: Handle, mask, axis: int,
                   keepdims: bool = False) -> Handle:
        """Row max over the *attendable* subset only (the relu-tree runs
        over the attendable wires).  Fully masked rows return the
        ``_MASKED_ROW`` sentinel; their probabilities are zeroed by the
        later mask select regardless."""
        raise NotImplementedError

    def lut(self, t: Handle, fn: Callable[[np.ndarray], np.ndarray],
            lo: int, hi: int, *,
            float_fn: Optional[Callable] = None,
            int_fn: Optional[Callable] = None) -> Handle:
        """Univariate table lookup over the saturated domain [lo, hi].
        ``fn`` maps int64 numpy → int64 numpy and defines the table on
        both integer lanes (bit-exact); ``float_fn`` is the real-valued
        counterpart (over torch tensors) the float lane applies instead.
        ``int_fn``, when given, is a torch expression bit-identical to
        ``fn`` that the int lane evaluates instead of building the table
        (large domains, e.g. the reciprocal over row sums)."""
        raise NotImplementedError

    # ---- ciphertext×ciphertext (dot-product baseline only) ---------------
    def mul(self, a: Handle, b: Handle) -> Handle:
        raise NotImplementedError

    def dot_scores(self, q: Handle, k: Handle) -> Handle:
        """(..., n_q, d) × (..., n_k, d) → (..., n_q, n_k) cipher–cipher
        contraction (QKᵀ)."""
        raise NotImplementedError

    def mix_values(self, p: Handle, v: Handle) -> Handle:
        """(..., n_q, n_k) × (..., n_k, d) → (..., n_q, d) cipher–cipher
        contraction (S·V)."""
        raise NotImplementedError

    # ---- cost attribution ------------------------------------------------
    @contextlib.contextmanager
    def scope(self, name: str):
        """Per-layer cost attribution (no-op on plaintext lanes)."""
        yield self

    # ---- derived ops (lane-generic) --------------------------------------
    def lut2(self, x: Handle, y: Handle,
             fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
             *, x_lo: int, x_hi: int, y_lo: int, y_hi: int,
             float_fn: Optional[Callable] = None) -> Handle:
        """Bivariate LUT via operand packing: ``p = (x−x_lo) + (y−y_lo)·W``
        with levelled ops, then one univariate PBS whose message width is
        the *packed* width.  Both operands saturate to their declared
        domains.  On the float lane ``float_fn(x, y)`` applies directly
        (to the same saturated operands)."""
        if self.is_float:
            return float_fn(self.clip(x, x_lo, x_hi),
                            self.clip(y, y_lo, y_hi))
        span = x_hi - x_lo + 1
        xc = self.clip(x, x_lo, x_hi)
        yc = self.clip(y, y_lo, y_hi)
        packed = self.add(self.mul_literal(yc, span), xc)
        base = y_lo * span + x_lo

        def packed_fn(p):
            pp = p - base
            xx = pp % span + x_lo
            yy = pp // span + y_lo
            return fn(xx, yy)

        return self.lut(packed, packed_fn,
                        y_lo * span + x_lo, y_hi * span + x_hi)


#: fill for rows with no attendable key: below every score representable
#: in the supported int32 regime (|Σq·k| < 2^30), while s − fill ≤ 2^30 +
#: 2^30 still fits int32
_MASKED_ROW = -(1 << 30)


def reciprocal_literal(n_max: int, count=None, base_bits: int = 8):
    """``1/count`` as a cleartext fixed-point literal with ~``base_bits``
    significant bits for ANY count up to ``n_max``.  Returns
    ``(literal, fraction_bits)``; apply as ``(x · literal) >> fraction``.
    ``count`` may be a numpy array or a tensor of counts."""
    f = base_bits + max(int(n_max) - 1, 1).bit_length()
    if count is None:
        return (1 << f) // max(int(n_max), 1), f
    return (1 << f) // count, f


# ---------------------------------------------------------------------------
# Plaintext lanes
# ---------------------------------------------------------------------------

class _TorchLane(Lane):
    """Shared ops of the float and int lanes (the reference's
    ``_JnpLane``): Python scalars keep the handle's dtype in torch, other
    literals enter through :meth:`array`."""

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def add(self, a, b):
        return a + self._lit(b)

    def sub(self, a, b):
        return a - self._lit(b)

    def mul_literal(self, t, c):
        return t * self.array(c)

    def select(self, mask, t, fill):
        return torch.where(self._mask(mask), t, fill)

    def relu(self, t):
        return torch.clamp_min(t, 0)

    def abs(self, t):
        return torch.abs(t)

    def max(self, t, axis, keepdims=False):
        return t.amax(dim=axis, keepdim=keepdims)

    def masked_max(self, t, mask, axis, keepdims=False):
        return torch.where(self._mask(mask), t, _MASKED_ROW).amax(
            dim=axis, keepdim=keepdims)

    def mul(self, a, b):
        return a * b


class FloatLane(_TorchLane):
    """torch float32 — the continuous reference the integer lanes chase."""

    name = "float"
    is_float = True

    def array(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def shift_right(self, t, k):
        return t / float(1 << k)            # exact divide — no rounding

    def matmul_plain(self, t, w):
        return torch.matmul(t, self.array(w))

    def sum(self, t, axis, keepdims=False):
        return t.sum(dim=axis, keepdim=keepdims)

    def lut(self, t, fn, lo, hi, *, float_fn=None, int_fn=None):
        if float_fn is None:
            raise ValueError("float lane needs the real-valued counterpart "
                             "(float_fn) of this table")
        return float_fn(self.clip(t, lo, hi))

    def dot_scores(self, q, k):
        return torch.matmul(q, k.transpose(-1, -2))

    def mix_values(self, p, v):
        return torch.matmul(p, v)


class IntLane(_TorchLane):
    """torch int32 — the paper's plaintext integer scaling arm.

    Every nonlinearity is a table built by the *same* numpy table
    function the FHE lane applies, so int-lane results are bit-exact with
    the TFHE simulator.  Every op ends in int32 and wraps modulo 2^32, as
    jnp's int32 arithmetic does.
    """

    name = "int"

    def array(self, x):
        return torch.as_tensor(x, dtype=torch.int32, device=self.device)

    def shift_right(self, t, k):
        return t >> k

    def matmul_plain(self, t, w):
        return exact_int_matmul(t, self.array(w)).to(torch.int32)

    def sum(self, t, axis, keepdims=False):
        return t.sum(dim=axis, keepdim=keepdims).to(torch.int32)

    def lut(self, t, fn, lo, hi, *, float_fn=None, int_fn=None):
        if int_fn is not None:
            return int_fn(self.clip(t, lo, hi))
        return _lookup(self.clip(t, lo, hi), fn, lo, hi, torch.int32)

    def dot_scores(self, q, k):
        return exact_int_matmul(q, k.transpose(-1, -2)).to(torch.int32)

    def mix_values(self, p, v):
        return exact_int_matmul(p, v).to(torch.int32)


# ---------------------------------------------------------------------------
# TFHE-simulated lane
# ---------------------------------------------------------------------------

class FheSimLane(Lane):
    """torch int64 arithmetic + TFHE cost accounting on a shared context.

    Handles are int64 tensors ("ciphertexts") on the context's device; the
    lane owns the :class:`FheContext` so costs from every layer accumulate
    in one place and :meth:`scope` attributes them per layer.
    """

    name = "fhe_sim"

    def __init__(self, ctx=None, device=None):
        from repro_torch.fhe.tfhe_sim import FheContext

        self.ctx = ctx if ctx is not None else FheContext(device=device)
        self.device = self.ctx.device

    # ---- ingest ----
    def array(self, x):
        # encryption itself is free
        return torch.as_tensor(x, dtype=torch.int64, device=self.device)

    # ---- levelled ----
    def add(self, a, b):
        out = a + self._lit(b)
        self.ctx.count_add(out)
        return out

    def sub(self, a, b):
        out = a - self._lit(b)
        self.ctx.count_add(out)
        return out

    def mul_literal(self, t, c):
        out = t * self.array(c)
        self.ctx.count_lit_mul(out)
        return out

    def shift_right(self, t, k):
        out = t >> k
        self.ctx.count_lit_mul(out)
        return out

    def matmul_plain(self, t, w):
        w = self.array(w)
        out = exact_int_matmul(t, w)
        n_vec = int(np.prod(t.shape[:-1], dtype=np.int64))
        d_in, d_out = w.shape
        self.ctx.count_lit_mul(out, n=n_vec * d_in * d_out)
        self.ctx.count_add(out, n=n_vec * max(d_in - 1, 0) * d_out)
        return out

    def sum(self, t, axis, keepdims=False):
        out = t.sum(dim=axis, keepdim=keepdims)
        self.ctx.count_add(out, n=max(t.numel() - out.numel(), 0))
        return out

    def select(self, mask, t, fill):
        out = torch.where(self._mask(mask), t, int(fill))
        self.ctx.count_lit_mul(out)
        return out

    # ---- PBS ----
    def relu(self, t):
        self.ctx.count_pbs(t)
        return torch.clamp_min(t, 0)

    def abs(self, t):
        self.ctx.count_pbs(t)
        return torch.abs(t)

    def max(self, t, axis, keepdims=False):
        # relu-tree: max(a, b) = b + relu(a − b) — ~1 PBS per element
        self.ctx.count_pbs(t)
        return t.amax(dim=axis, keepdim=keepdims)

    def masked_max(self, t, mask, axis, keepdims=False):
        m = self._mask(mask).expand(t.shape)
        # the relu-tree runs over attendable wires only: PBS count and
        # width observation cover just those elements
        self.ctx._bump("pbs", int(m.sum().item()))
        self.ctx._observe(torch.where(m, t, 0), at_pbs=True)
        return torch.where(m, t, _MASKED_ROW).amax(dim=axis,
                                                   keepdim=keepdims)

    def lut(self, t, fn, lo, hi, *, float_fn=None, int_fn=None):
        vals = self.clip(t, lo, hi)
        self.ctx.count_pbs(vals)
        return _lookup(vals, fn, lo, hi, torch.int64)

    # ---- ciphertext×ciphertext ----
    def mul(self, a, b):
        s = a + b
        d = a - b
        self.ctx.count_cmul(s, d)
        out = (s * s - d * d) // 4
        self.ctx._observe(out, at_pbs=False)
        return out

    def dot_scores(self, q, k):
        qe = q[..., :, None, :]
        ke = k[..., None, :, :]
        shp = torch.broadcast_shapes(qe.shape, ke.shape)
        prod = self.mul(qe.expand(shp), ke.expand(shp))
        return self.sum(prod, axis=-1)

    def mix_values(self, p, v):
        pe = p[..., :, :, None]
        ve = v[..., None, :, :]
        shp = torch.broadcast_shapes(pe.shape, ve.shape)
        prod = self.mul(pe.expand(shp), ve.expand(shp))
        return self.sum(prod, axis=-2)

    # ---- cost attribution ----
    @contextlib.contextmanager
    def scope(self, name: str):
        with self.ctx.scope(name):
            yield self


_LANES = {"float": FloatLane, "int": IntLane, "fhe_sim": FheSimLane}


def get_lane(name: str, ctx=None, device=None) -> Lane:
    """Lane factory: ``float`` | ``int`` | ``fhe_sim`` on ``device``
    (default: the card), or the static analyzer's ``interval`` lane,
    whose bounds are exact int64 on the host (a ``device`` other than the
    CPU is refused).  ``fhe_sim`` and ``interval`` accept a shared
    :class:`~repro_torch.fhe.tfhe_sim.FheContext` for cross-layer cost
    accumulation; ``fhe_sim`` then runs on that context's device."""
    if name == "interval":
        if device is not None and torch.device(device).type != "cpu":
            raise ValueError(
                f"the interval lane runs on the host, not on {device!r}: "
                "its bounds are exact int64 up to 2^62, which no card "
                "multiplies exactly")
        # lazy: repro_torch.analysis imports this module
        from repro_torch.analysis.interval_lane import IntervalLane
        return IntervalLane(ctx)
    try:
        cls = _LANES[name]
    except KeyError:
        raise ValueError(f"unknown lane {name!r}; known: "
                         f"{sorted(set(_LANES) | {'interval'})}") from None
    if name == "fhe_sim":
        return cls(ctx, device=device)
    return cls(device=device)


def available_lanes() -> Sequence[str]:
    return tuple(sorted(_LANES))
