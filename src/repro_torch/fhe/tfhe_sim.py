"""TFHE circuit simulator: exact integer semantics + cost/noise accounting.

Port of :mod:`repro.fhe.tfhe_sim`.  "Ciphertexts" are torch int64
tensors on the context's device (the card unless the caller names the
CPU).  Every homomorphic operation executes the exact integer arithmetic
(so circuit outputs are bit-exact with a cleartext reference) while a
:class:`FheContext` records, per TFHE's actual cost structure:

  * ``pbs``      — programmable bootstraps.  Univariate LUT = 1 PBS per
                   element; ciphertext×ciphertext multiplication = 2 PBS per
                   element via the paper's eq. 1–2 identity
                   ``ab = PBS(x²/4; a+b) − PBS(x²/4; a−b)``.
  * ``cmuls``    — ciphertext×ciphertext multiplications (the op the
                   inhibitor exists to avoid; each one also costs 2 PBS,
                   already included in ``pbs``).
  * ``adds``     — ciphertext additions/subtractions (levelled, cheap).
  * ``lit_muls`` — literal (plaintext-constant) multiplications (cheap).
  * ``max_bits`` — the message-space bit-width high-water mark: every
                   intermediate's dynamic range is tracked, because TFHE
                   circuit parameters (polySize, lweDim) are chosen from the
                   largest value that must survive a PBS (paper Table 2).

Counts come from shapes alone.  The widths need the largest |value| of
each op's result: one device reduction and one host read per op.

Per-layer attribution: :meth:`FheContext.scope` opens a named accounting
scope; every counter update lands in the active scope as well as the
totals.  ``scope_report()`` returns the per-scope summaries — the data
:func:`repro_torch.fhe.params.select_params_for_report` and the per-layer
cost tables are built from.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class FheContext:
    """Operation counters + message-space tracking for one circuit, whose
    ciphertexts live on ``device`` (default: the card)."""

    pbs: int = 0
    cmuls: int = 0
    adds: int = 0
    lit_muls: int = 0
    max_bits: int = 0           # widest signed message seen at a PBS input
    max_bits_any: int = 0       # widest signed message anywhere
    per_scope: Dict[str, dict] = dataclasses.field(default_factory=dict)
    _scope: Optional[str] = None
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # ---- scoping -----------------------------------------------------
    @contextlib.contextmanager
    def scope(self, name: str):
        """Attribute every counter update inside the block to ``name``
        (in addition to the totals).  Scopes do not nest — the innermost
        name wins, which is what per-layer attribution wants."""
        prev = self._scope
        self._scope = name
        self.per_scope.setdefault(name, {
            "pbs": 0, "cmuls": 0, "adds": 0, "lit_muls": 0,
            "max_bits_at_pbs": 0, "max_bits_any": 0})
        try:
            yield self
        finally:
            self._scope = prev

    def _bump(self, counter: str, n: int):
        setattr(self, counter, getattr(self, counter) + n)
        if self._scope is not None:
            self.per_scope[self._scope][counter] += n

    # ---- width tracking ----------------------------------------------
    def _observe(self, arr: torch.Tensor, at_pbs: bool):
        amax = int(arr.abs().max().item()) if arr.numel() else 0
        bits = max(1, amax.bit_length()) + 1       # signed representation
        self.max_bits_any = max(self.max_bits_any, bits)
        if at_pbs:
            self.max_bits = max(self.max_bits, bits)
        if self._scope is not None:
            s = self.per_scope[self._scope]
            s["max_bits_any"] = max(s["max_bits_any"], bits)
            if at_pbs:
                s["max_bits_at_pbs"] = max(s["max_bits_at_pbs"], bits)

    # ---- counting (the only mutation API — scope attribution lives
    # here, so EncTensor and FheSimLane both route through it) ---------
    def count_pbs(self, arr: torch.Tensor, n_per_element: int = 1):
        self._bump("pbs", arr.numel() * n_per_element)
        self._observe(arr, at_pbs=True)

    def count_cmul(self, s: torch.Tensor, d: torch.Tensor):
        """One ciphertext multiply per element: 2 PBS over the packed
        sums/differences a±b (eq. 1), plus the surrounding adds."""
        self._bump("cmuls", s.numel())
        self.count_pbs(s, 1)
        self.count_pbs(d, 1)
        self._bump("adds", 3 * s.numel())

    def count_add(self, arr: torch.Tensor, n: Optional[int] = None):
        self._bump("adds", arr.numel() if n is None else int(n))
        self._observe(arr, at_pbs=False)

    def count_lit_mul(self, arr: torch.Tensor, n: Optional[int] = None):
        self._bump("lit_muls", arr.numel() if n is None else int(n))
        self._observe(arr, at_pbs=False)

    def summary(self) -> dict:
        return {
            "pbs": self.pbs,
            "cmuls": self.cmuls,
            "adds": self.adds,
            "lit_muls": self.lit_muls,
            "max_bits_at_pbs": self.max_bits,
            "max_bits_any": self.max_bits_any,
        }

    def scope_report(self) -> Dict[str, dict]:
        """Per-scope summaries (insertion order = execution order)."""
        return {k: dict(v) for k, v in self.per_scope.items()}


class EncTensor:
    """An "encrypted" integer tensor: exact values + cost accounting.

    Supports exactly the operations TFHE supports natively or via PBS:
    add/sub (cheap), multiply-by-literal (cheap), univariate LUT (1 PBS per
    element), ciphertext multiply (2 PBS per element), and the derived
    relu/abs/sign helpers.  ``values`` is an int64 tensor on the
    context's device.
    """

    def __init__(self, values, ctx: FheContext):
        self.ctx = ctx
        self.values = self._ingest(values)

    def _ingest(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.int64, device=self.ctx.device)

    # ---- structure ----
    @property
    def shape(self):
        return tuple(self.values.shape)

    def reshape(self, *shape):
        return EncTensor(self.values.reshape(*shape), self.ctx)

    def __getitem__(self, idx):
        return EncTensor(self.values[idx], self.ctx)

    # ---- levelled ops (no PBS) ----
    def __add__(self, other):
        other = other.values if isinstance(other, EncTensor) else other
        out = self.values + self._ingest(other)
        self.ctx.count_add(out)
        return EncTensor(out, self.ctx)

    def __sub__(self, other):
        other = other.values if isinstance(other, EncTensor) else other
        out = self.values - self._ingest(other)
        self.ctx.count_add(out)
        return EncTensor(out, self.ctx)

    def __neg__(self):
        return EncTensor(-self.values, self.ctx)

    def mul_literal(self, c) -> "EncTensor":
        out = self.values * self._ingest(c)
        self.ctx.count_lit_mul(out)
        return EncTensor(out, self.ctx)

    def shift_right(self, k: int) -> "EncTensor":
        """Arithmetic shift (literal division by 2^k) — levelled rescale."""
        out = self.values >> k
        self.ctx.count_lit_mul(out)
        return EncTensor(out, self.ctx)

    def sum(self, axis=None) -> "EncTensor":
        out = (self.values.sum() if axis is None
               else self.values.sum(dim=axis))
        # a tree of ciphertext additions
        self.ctx.count_add(out, n=max(self.values.numel() - out.numel(), 0))
        return EncTensor(out, self.ctx)

    # ---- PBS ops ----
    def lut(self, fn: Callable[[torch.Tensor], torch.Tensor],
            n_pbs: int = 1) -> "EncTensor":
        """Univariate table lookup: 1 PBS per element.  ``fn`` is an
        elementwise function over int64 tensors.

        The *input* range determines the required table size — that is the
        message-space bit-width recorded for parameter selection.
        """
        self.ctx.count_pbs(self.values, n_pbs)
        return EncTensor(fn(self.values), self.ctx)

    def relu(self) -> "EncTensor":
        return self.lut(lambda x: torch.clamp_min(x, 0))

    def abs(self) -> "EncTensor":
        return self.lut(torch.abs)

    def sign(self) -> "EncTensor":
        return self.lut(torch.sign)

    def mul_cipher(self, other: "EncTensor") -> "EncTensor":
        """Ciphertext × ciphertext via eq. 1: two PBS of x²/4 over a+b, a−b.

        Exact for integers: (a+b)² − (a−b)² = 4ab; the x²/4 table rounds,
        and the two roundings cancel exactly when a+b and a−b share parity
        (always true). PBS inputs a±b are observed for width tracking —
        the +1 bit over the operands is the paper's Table 2 gap.
        """
        s = self.values + other.values
        d = self.values - other.values
        self.ctx.count_cmul(s, d)
        out = (s * s - d * d) // 4
        self.ctx._observe(out, at_pbs=False)
        return EncTensor(out, self.ctx)


def encrypt(values, ctx: Optional[FheContext] = None):
    ctx = ctx or FheContext()
    return EncTensor(values, ctx), ctx


def decrypt(t: EncTensor) -> np.ndarray:
    return t.values.cpu().numpy().copy()
