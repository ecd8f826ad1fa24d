"""Abstract-interpretation lane: the :class:`~repro_torch.core.lanes.Lane`
protocol over symbolic per-element interval bounds.

Port of :mod:`repro.analysis.interval_lane`.  Running any lane-generic
program (both attention mechanisms, the PTQ'd layers, the whole-model
forward) on an :class:`IntervalLane` executes *no concrete data* —
handles are :class:`~repro_torch.analysis.interval.IntervalTensor`
bounds — yet produces the exact same static op trace the ``fhe_sim``
lane measures: op counts are shape-determined and shapes are concrete,
so PBS / cmul / add / lit-mul counters agree *exactly* with a measured
forward, while every message-width observation is the proven worst case
over all inputs in the declared quantized ranges.

Soundness contract (tested in tests/test_torch_analysis.py): for any
concrete input whose elements lie inside the ingested intervals, an
``fhe_sim`` forward of the same program observes, in every scope, per-op
counts equal to — and ``max_bits_at_pbs`` / ``max_bits_any`` dominated
by — this lane's static trace.  The mechanics:

  * cost accounting reuses :class:`repro_torch.fhe.tfhe_sim.FheContext`
    verbatim, on the CPU — counters receive zero-copy "magnitude
    proxies" (a 0-d int64 tensor holding the interval's worst absolute
    value, ``expand``-ed to the op's shape), so the width bookkeeping
    (signed-bit formula, at-PBS vs anywhere, scope attribution) is the
    measured lane's own code path;
  * every cipher×cipher multiply records a **cmul site** (scope, op,
    count, PBS width of the packed a±b operands) — the inhibitor family's
    zero-cmul claim becomes checkable as ``cmul_sites == []``;
  * every LUT records a **site report** (declared domain, raw input
    interval, saturation margins, required table width) — parameter
    selection and the LUT-domain verification gate read these.

The bounds are numpy int64 on the host (see
:mod:`repro_torch.analysis.interval` for why not on the card).  The
structure ops the base lane writes for torch tensors (``permute``,
``unsqueeze``, ``repeat_interleave``, negation, ``clamp``, the mask) are
overridden here for interval handles; ``lut2`` stays the base lane's.

Control flow in lane-generic programs never branches on ciphertext values
(TFHE could not execute it if it did), so one abstract trace covers every
input of the given shape/config — that is what turns "zero cmuls observed"
into "zero cmuls, proven".
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import numpy as np

import torch

from repro_torch.analysis.interval import (MAX_LUT_DOMAIN, IntervalTensor,
                                           as_interval, broadcast_interval,
                                           literal_mul_bounds,
                                           matmul_plain_bounds, mul_bounds,
                                           table_range_minmax)
from repro_torch.core.lanes import _MASKED_ROW, Lane, _host

_SENTINEL_MIN = np.iinfo(np.int64).min


class IntervalLane(Lane):
    """Static-analysis lane: interval transfer functions + the measured
    lane's own cost accounting over magnitude proxies."""

    name = "interval"
    #: the bounds and the cost context live on the host
    device = torch.device("cpu")

    def __init__(self, ctx=None):
        from repro_torch.fhe.tfhe_sim import FheContext

        self.ctx = ctx if ctx is not None else FheContext(device="cpu")
        #: cipher×cipher sites: {scope, op, count, pbs_bits}
        self.cmul_sites: List[dict] = []
        #: LUT sites: {scope, domain, input, saturated, table_bits, fits}
        self.lut_sites: List[dict] = []
        #: per-scope proven value ranges [lo, hi] over every intermediate
        self.value_ranges: dict = {}
        self._scope: Optional[str] = None
        self._op: Optional[str] = None   # contraction label for cmul sites

    # ---- bookkeeping helpers -------------------------------------------
    def _proxy(self, t: IntervalTensor) -> torch.Tensor:
        """Zero-copy magnitude proxy: worst |value| as a 0-d CPU int64
        tensor expanded to the op's shape, so FheContext sees the right
        element count AND the proven worst-case width through its
        unmodified counting API."""
        return torch.tensor(t.max_abs(), dtype=torch.int64).expand(t.shape)

    def _note(self, t: IntervalTensor) -> IntervalTensor:
        """Record the interval into the active scope's value range."""
        scope = self._scope or "<root>"
        lo, hi = t.extremes()
        cur = self.value_ranges.get(scope)
        if cur is None:
            self.value_ranges[scope] = [lo, hi]
        else:
            cur[0] = min(cur[0], lo)
            cur[1] = max(cur[1], hi)
        return t

    # ---- ingest / export ------------------------------------------------
    def array(self, x):
        return as_interval(_cleartext(x))

    def embed(self, table: np.ndarray, tokens):
        """Symbolic client-side embedding: the analysis must hold for ANY
        token sequence of this shape, so each channel's interval spans the
        whole vocabulary's quantized rows; ``tokens`` contributes shape
        only (its values are never read)."""
        table = np.asarray(_host(table), np.int64)
        shp = (tuple(tokens.shape) if isinstance(tokens, torch.Tensor)
               else np.shape(tokens)) + table.shape[1:]
        lo = np.broadcast_to(table.min(axis=0), shp).copy()
        hi = np.broadcast_to(table.max(axis=0), shp).copy()
        return self._note(IntervalTensor(lo, hi, what="embed"))

    def to_numpy(self, t):
        raise TypeError(
            "IntervalLane handles are abstract bounds, not values; read "
            "handle.lo / handle.hi (or .extremes()) instead of to_numpy()")

    def shape(self, t):
        return t.shape

    def _mask(self, mask) -> np.ndarray:
        return np.asarray(_host(mask), bool)

    # ---- structure ------------------------------------------------------
    def transpose(self, t, axes):
        return t.transpose(axes)

    def expand_dims(self, t, axis):
        return IntervalTensor(np.expand_dims(t.lo, axis),
                              np.expand_dims(t.hi, axis))

    def repeat(self, t, rep, axis):
        return IntervalTensor(np.repeat(t.lo, rep, axis=axis),
                              np.repeat(t.hi, rep, axis=axis))

    # reshape: the base Lane delegates to the handle's method

    # ---- levelled ops ---------------------------------------------------
    def add(self, a, b):
        b = self.array(b)
        out = IntervalTensor(a.lo + b.lo, a.hi + b.hi, what="add")
        self.ctx.count_add(self._proxy(out))
        return self._note(out)

    def sub(self, a, b):
        b = self.array(b)
        out = IntervalTensor(a.lo - b.hi, a.hi - b.lo, what="sub")
        self.ctx.count_add(self._proxy(out))
        return self._note(out)

    def neg(self, t):
        return IntervalTensor(-t.hi, -t.lo, what="neg")

    def mul_literal(self, t, c):
        out = literal_mul_bounds(t, _cleartext(c))
        self.ctx.count_lit_mul(self._proxy(out))
        return self._note(out)

    def shift_right(self, t, k):
        # arithmetic shift is monotone non-decreasing, endpoints map over
        out = IntervalTensor(t.lo >> k, t.hi >> k, what="shift_right")
        self.ctx.count_lit_mul(self._proxy(out))
        return self._note(out)

    def matmul_plain(self, t, w):
        w = np.asarray(_host(w), np.int64)
        out = matmul_plain_bounds(t, w)
        n_vec = int(np.prod(t.shape[:-1], dtype=np.int64))
        d_in, d_out = w.shape
        self.ctx.count_lit_mul(self._proxy(out), n=n_vec * d_in * d_out)
        self.ctx.count_add(self._proxy(out),
                           n=n_vec * max(d_in - 1, 0) * d_out)
        return self._note(out)

    def sum(self, t, axis, keepdims=False):
        out = IntervalTensor(t.lo.sum(axis=axis, keepdims=keepdims),
                             t.hi.sum(axis=axis, keepdims=keepdims),
                             what="sum")
        self.ctx.count_add(self._proxy(out),
                           n=max(int(t.size - out.size), 0))
        return self._note(out)

    def select(self, mask, t, fill):
        m = self._mask(mask)
        fill = np.int64(fill)
        out = IntervalTensor(np.where(m, t.lo, fill),
                             np.where(m, t.hi, fill), what="select")
        self.ctx.count_lit_mul(self._proxy(out))
        return self._note(out)

    def clip(self, t, lo, hi):
        return IntervalTensor(np.clip(t.lo, lo, hi), np.clip(t.hi, lo, hi),
                              what="clip")

    # ---- PBS ops --------------------------------------------------------
    def relu(self, t):
        self.ctx.count_pbs(self._proxy(t))
        return self._note(IntervalTensor(np.maximum(t.lo, 0),
                                         np.maximum(t.hi, 0), what="relu"))

    def abs(self, t):
        self.ctx.count_pbs(self._proxy(t))
        alo, ahi = np.abs(t.lo), np.abs(t.hi)
        hi = np.maximum(alo, ahi)
        lo = np.where(t.lo > 0, t.lo, np.where(t.hi < 0, -t.hi, 0))
        return self._note(IntervalTensor(lo, hi, what="abs"))

    def max(self, t, axis, keepdims=False):
        self.ctx.count_pbs(self._proxy(t))
        return self._note(IntervalTensor(
            t.lo.max(axis=axis, keepdims=keepdims),
            t.hi.max(axis=axis, keepdims=keepdims), what="max"))

    def masked_max(self, t, mask, axis, keepdims=False):
        m = np.broadcast_to(self._mask(mask), t.shape)
        # mirror FheSimLane: the relu-tree covers attendable wires only
        self.ctx._bump("pbs", int(m.sum()))
        mag = np.where(m, np.maximum(np.abs(t.lo), np.abs(t.hi)), 0)
        self.ctx._observe(
            torch.tensor([int(mag.max()) if mag.size else 0],
                         dtype=torch.int64), at_pbs=True)
        lo_m = np.where(m, t.lo, _SENTINEL_MIN)
        hi_m = np.where(m, t.hi, _SENTINEL_MIN)
        any_m = m.any(axis=axis, keepdims=keepdims)
        lo = np.where(any_m, lo_m.max(axis=axis, keepdims=keepdims),
                      np.int64(_MASKED_ROW))
        hi = np.where(any_m, hi_m.max(axis=axis, keepdims=keepdims),
                      np.int64(_MASKED_ROW))
        return self._note(IntervalTensor(lo, hi, what="masked_max"))

    def lut(self, t, fn, lo, hi, *, float_fn=None, int_fn=None):
        span = int(hi) - int(lo) + 1
        if span > MAX_LUT_DOMAIN:
            raise ValueError(
                f"LUT domain [{lo}, {hi}] has {span} entries — beyond the "
                f"analyzer's {MAX_LUT_DOMAIN}-entry materialization cap")
        cl = np.clip(t.lo, lo, hi)
        ch = np.clip(t.hi, lo, hi)
        sat = IntervalTensor(cl, ch, what="lut-input")
        # the PBS covers the *saturated* input — same width semantics as
        # FheSimLane.lut (which observes its input clamped to [lo, hi])
        self.ctx.count_pbs(self._proxy(sat))
        raw_lo, raw_hi = t.extremes()
        sat_lo, sat_hi = sat.extremes()
        table_bits = max(1, int(sat.max_abs()).bit_length()) + 1
        self.lut_sites.append({
            "scope": self._scope or "<root>",
            "domain": [int(lo), int(hi)],
            "input": [raw_lo, raw_hi],
            "saturated": [sat_lo, sat_hi],
            "overflow_lo": max(int(lo) - raw_lo, 0),
            "overflow_hi": max(raw_hi - int(hi), 0),
            "fits_domain": int(lo) <= raw_lo and raw_hi <= int(hi),
            "table_bits": table_bits,
        })
        domain = np.arange(lo, hi + 1, dtype=np.int64)
        tbl = np.asarray(fn(domain), dtype=np.int64)
        out_lo, out_hi = table_range_minmax(tbl, cl - lo, ch - lo)
        return self._note(IntervalTensor(out_lo, out_hi, what="lut"))

    # ---- ciphertext×ciphertext (dot-product arm only) -------------------
    def mul(self, a, b):
        s = IntervalTensor(a.lo + b.lo, a.hi + b.hi, what="cmul-pack")
        d = IntervalTensor(a.lo - b.hi, a.hi - b.lo, what="cmul-pack")
        self.ctx.count_cmul(self._proxy(s), self._proxy(d))
        self.cmul_sites.append({
            "scope": self._scope or "<root>",
            "op": self._op or "mul",
            "count": s.size,
            "pbs_bits": max(
                1, int(max(s.max_abs(), d.max_abs())).bit_length()) + 1,
        })
        out = mul_bounds(a, b, what="cipher-mul")
        self.ctx._observe(self._proxy(out), at_pbs=False)
        return self._note(out)

    def dot_scores(self, q, k):
        qe = IntervalTensor(q.lo[..., :, None, :], q.hi[..., :, None, :])
        ke = IntervalTensor(k.lo[..., None, :, :], k.hi[..., None, :, :])
        shp = np.broadcast_shapes(qe.shape, ke.shape)
        self._op = "dot_scores"
        try:
            prod = self.mul(broadcast_interval(qe, shp),
                            broadcast_interval(ke, shp))
        finally:
            self._op = None
        return self.sum(prod, axis=-1)

    def mix_values(self, p, v):
        pe = IntervalTensor(p.lo[..., :, :, None], p.hi[..., :, :, None])
        ve = IntervalTensor(v.lo[..., None, :, :], v.hi[..., None, :, :])
        shp = np.broadcast_shapes(pe.shape, ve.shape)
        self._op = "mix_values"
        try:
            prod = self.mul(broadcast_interval(pe, shp),
                            broadcast_interval(ve, shp))
        finally:
            self._op = None
        return self.sum(prod, axis=-2)

    # ---- cost attribution ----------------------------------------------
    @contextlib.contextmanager
    def scope(self, name: str):
        prev = self._scope
        self._scope = name
        with self.ctx.scope(name):
            try:
                yield self
            finally:
                self._scope = prev


def _cleartext(x):
    """A cleartext operand (literal, table, bias; numpy, torch or a
    Python scalar) or an interval handle, as the interval domain reads
    it."""
    return x if isinstance(x, IntervalTensor) else _host(x)
