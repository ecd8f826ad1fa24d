"""Integer interval domain for the static circuit analyzer.

The abstract value is a per-element signed integer interval ``[lo, hi]``:
an :class:`IntervalTensor` carries two ``np.int64`` arrays of the tensor's
shape, and every transfer function here is *sound* — for any concrete
element ``x ∈ [lo_e, hi_e]`` the concrete op result lies inside the
abstract result's interval.  Per-element (rather than per-tensor) bounds
matter because cleartext weights are concrete: a plaintext-weight matmul
bounds each output channel by the channel's own signed weight column, which
is what keeps whole-block widths near the measured high-water instead of a
uniform worst case over the weight clip.

Bounds are exact int64 arithmetic with an explicit headroom guard — a bound
past ``2^62`` raises :class:`IntervalOverflow` instead of silently wrapping
(wrapped bounds would be an unsound analysis, the one failure mode a static
analyzer must never have).

Port of :mod:`repro.analysis.interval`, numpy on the host as there, by
design and not as a fallback: the endpoints run up to the 2^62 guard;
CUDA has no integer matmul (torch's ``addmm`` is not implemented for
int64 there); and float64, the card's only exact substitute, holds
integers exactly only below 2^53, so :func:`matmul_plain_bounds` has no
sound form on the card.  The analysis reads no data, only bounds, so
the card has nothing to speed up here.
"""

from __future__ import annotations

import numpy as np

#: int64 headroom guard: interval endpoints past this magnitude abort the
#: analysis (products of two guarded endpoints still need checking by the
#: caller *before* they are materialized — see :func:`mul_bounds`).
GUARD = np.int64(1) << 62

#: largest LUT domain the analyzer will materialize (tables are evaluated
#: over the whole declared domain to bound outputs by range min/max)
MAX_LUT_DOMAIN = 1 << 24


class IntervalOverflow(OverflowError):
    """Static bounds left the exact-int64 regime — the analysis cannot
    continue soundly (the circuit would overflow the lanes long before)."""


def _checked(lo: np.ndarray, hi: np.ndarray, what: str = "op"):
    lo = np.asarray(lo, np.int64)
    hi = np.asarray(hi, np.int64)
    if lo.shape != hi.shape:
        lo, hi = np.broadcast_arrays(lo, hi)
        lo, hi = lo.copy(), hi.copy()
    if lo.size and (int(np.max(np.abs(lo))) >= GUARD
                    or int(np.max(np.abs(hi))) >= GUARD):
        raise IntervalOverflow(
            f"static interval bound exceeded 2^62 during {what!r}; the "
            "circuit's worst case overflows exact int64 analysis")
    if lo.size and np.any(lo > hi):
        raise ValueError(f"inverted interval produced by {what!r} "
                         "(analyzer bug: lo > hi)")
    return lo, hi


class IntervalTensor:
    """Abstract lane handle: per-element signed integer bounds."""

    __slots__ = ("lo", "hi")

    def __init__(self, lo, hi, *, what: str = "interval"):
        self.lo, self.hi = _checked(lo, hi, what)

    # ---- ndarray-protocol surface the base Lane structure ops use ----
    @property
    def shape(self):
        return self.lo.shape

    @property
    def ndim(self) -> int:
        return self.lo.ndim

    @property
    def size(self) -> int:
        return int(self.lo.size)

    def reshape(self, shape):
        return IntervalTensor(self.lo.reshape(shape), self.hi.reshape(shape))

    def transpose(self, axes):
        return IntervalTensor(self.lo.transpose(axes),
                              self.hi.transpose(axes))

    def __getitem__(self, idx):
        return IntervalTensor(self.lo[idx], self.hi[idx])

    # ---- summaries ----
    def extremes(self):
        """Global (min lo, max hi) as python ints (0, 0) when empty."""
        if not self.lo.size:
            return 0, 0
        return int(self.lo.min()), int(self.hi.max())

    def max_abs(self) -> int:
        lo, hi = self.extremes()
        return max(abs(lo), abs(hi))

    def __repr__(self):
        lo, hi = self.extremes()
        return f"IntervalTensor(shape={self.shape}, range=[{lo}, {hi}])"


def as_interval(x) -> IntervalTensor:
    """Concrete scalar/array → exact (degenerate) interval."""
    if isinstance(x, IntervalTensor):
        return x
    a = np.asarray(x, np.int64)
    return IntervalTensor(a, a.copy())


def broadcast_interval(t: IntervalTensor, shape) -> IntervalTensor:
    return IntervalTensor(np.broadcast_to(t.lo, shape).copy(),
                          np.broadcast_to(t.hi, shape).copy())


def mul_bounds(a: IntervalTensor, b: IntervalTensor,
               what: str = "mul") -> IntervalTensor:
    """Sound product interval: elementwise min/max over the four endpoint
    products.  Endpoint products are pre-checked in float so an int64 wrap
    can never produce a silently-unsound bound."""
    if float(a.max_abs()) * float(b.max_abs()) >= float(GUARD):
        raise IntervalOverflow(
            f"interval product exceeds 2^62 during {what!r}")
    p1 = a.lo * b.lo
    p2 = a.lo * b.hi
    p3 = a.hi * b.lo
    p4 = a.hi * b.hi
    lo = np.minimum(np.minimum(p1, p2), np.minimum(p3, p4))
    hi = np.maximum(np.maximum(p1, p2), np.maximum(p3, p4))
    return IntervalTensor(lo, hi, what=what)


def literal_mul_bounds(t: IntervalTensor, c) -> IntervalTensor:
    """Interval × concrete cleartext literal (scalar or array)."""
    return mul_bounds(t, as_interval(c), what="mul_literal")


def matmul_plain_bounds(t: IntervalTensor, w: np.ndarray) -> IntervalTensor:
    """(..., d_in) × concrete (d_in, d_out): per-output-channel bounds via
    the signed split w = w⁺ + w⁻ (w⁺ = max(w, 0), w⁻ = min(w, 0))."""
    w = np.asarray(w, np.int64)
    if float(t.max_abs()) * float(np.abs(w).sum(axis=0).max(initial=0)) \
            >= float(GUARD):
        raise IntervalOverflow("matmul_plain bound exceeds 2^62")
    wp = np.maximum(w, 0)
    wn = np.minimum(w, 0)
    lo = t.lo @ wp + t.hi @ wn
    hi = t.hi @ wp + t.lo @ wn
    return IntervalTensor(lo, hi, what="matmul_plain")


# ---------------------------------------------------------------------------
# Range min/max over materialized LUT tables (sparse-table RMQ)
# ---------------------------------------------------------------------------

def table_range_minmax(tbl: np.ndarray, i0: np.ndarray, i1: np.ndarray):
    """Vectorized inclusive range min/max over ``tbl``: for each query
    ``(i0_e, i1_e)`` return ``(min tbl[i0_e:i1_e+1], max ...)``.

    Bounds a LUT output by the table's extremes over the *reachable*
    (saturated) input range of each element.  O(D log D) sparse-table
    build, O(1) per query — domains are bounded by MAX_LUT_DOMAIN.
    """
    tbl = np.asarray(tbl, np.int64)
    i0 = np.asarray(i0, np.intp)
    i1 = np.asarray(i1, np.intp)
    if np.any(i0 > i1):
        raise ValueError("range query with i0 > i1")
    n = tbl.shape[0]
    if n == 0:
        raise ValueError("empty LUT table")
    # sparse tables: level k covers windows of 2^k
    mins, maxs = [tbl], [tbl]
    k = 1
    while (1 << k) <= n:
        half = 1 << (k - 1)
        prev_mn, prev_mx = mins[-1], maxs[-1]
        mins.append(np.minimum(prev_mn[:-half], prev_mn[half:]))
        maxs.append(np.maximum(prev_mx[:-half], prev_mx[half:]))
        k += 1
    length = i1 - i0 + 1
    # floor(log2(length)) per query
    lev = np.frexp(length.astype(np.float64))[1] - 1
    lev = np.clip(lev, 0, len(mins) - 1).astype(np.intp)
    lo_out = np.empty(i0.shape, np.int64)
    hi_out = np.empty(i0.shape, np.int64)
    for level in np.unique(lev):
        sel = lev == level
        span = 1 << int(level)
        a = i0[sel]
        b = i1[sel] - span + 1
        lo_out[sel] = np.minimum(mins[level][a], mins[level][b])
        hi_out[sel] = np.maximum(maxs[level][a], maxs[level][b])
    return lo_out, hi_out
