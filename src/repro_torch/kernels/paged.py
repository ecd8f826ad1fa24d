"""Paged decode kernels: block-table-native inhibitor / Softmax decode.

Serving decode keeps KV rows in a shared pool of pages behind per-slot
block tables.  These wrappers launch the hand-written CUDA kernels of
``csrc/paged_decode.cu``, which walk each row's table inside the kernel
(no contiguous gather of the pool):

=================================  ==========================================
wrapper                            replaces (TPU Pallas kernel)
=================================  ==========================================
:func:`paged_flash_inhibitor_fwd`  ``repro/kernels/paged.py:124``
                                   ``_paged_inhibitor_kernel``
:func:`paged_flash_attention_fwd`  ``repro/kernels/paged.py:259``
                                   ``_paged_attention_kernel``
=================================  ==========================================

Both are bound by the bytes of the valid KV pages (each read once; a few
float32 instructions per byte, below the card's ridge point), about
1.03 MB at the serve shape: at that size a launch and a chain of
dependent loads, not the bytes, set the time.

Both kernels are split over pages (flash-decoding), one design twice:
one block of 4 warps per (row, kv head, split), ``n_splits =
ceil(table_width / pages_per_step)`` (:func:`attention_splits`) fixed
from the table width (the host never reads ``lengths``; the serve tick
keeps its 2 h2d + 1 d2h copies), so ``pages_per_step`` is the pages per
split.  Each block reads K and V rows 16 bytes a lane straight from the
pool (no shared-memory staging), reduces each key's score over its
lanes by shuffles and keeps its sums in registers.  With more than one
split a second small kernel merges the float32 partials (scratch from
``torch.empty``), in split order; both launches count as one in the
wrapper's ``launches``.

* The inhibitor keeps, per (kv head, dim), the split's sum of v, and per
  (query head, dim) the sign-folded sum of -sgn(v) min(|v|, z)
  (unsigned: -min(v, z)); a split's partial is their sum, a plain sum,
  so the merge adds the partials of the splits holding an attendable
  key and divides by the count ``k_hi - k_lo`` it computes from
  ``lengths`` and the window.  A split with no attendable key writes
  nothing.
* The Softmax keeps the online softmax (m, l, acc); a split with no
  attendable key writes an empty partial (m = -1e30, l = 0), and the
  merge rescales the partials to their common max and writes ``acc /
  max(l, 1e-20)``.

A row with no attendable key writes 0.  What stands between either
kernel and its bound: the merge's second launch, the dependent-load
latency inside a split, the launch itself.

Keys past a row's cursor are left out by predicate and never loaded, and
table entries past the cursor (trash page 0) are never read.  The
source's header note gives the count and the design.

Beside each wrapper sits its plain version (:func:`paged_flash_inhibitor_
plain`, :func:`paged_flash_attention_plain`: gather + dense masked form,
from :mod:`repro_torch.kernels.ref`).  A wrapper takes the plain version
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises — it never falls back.  Each wrapper counts its kernel launches in
``<wrapper>.launches`` and each plain version its calls in
``<plain>.calls`` (:func:`reset_counts` zeroes them), so a run can show
which path it took.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ref as kref

DEFAULT_PAGES_PER_STEP = 4

#: Platforms (tensor device types) these kernels run natively on.
LOWERS_ON = ("cuda",)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# both split kernels keep q and the sums of each of the group's heads in
# registers (one instantiation per group), and each lane loads 16 bytes
# of a key row
_SPLIT_MAX_GROUP = 8
_SPLIT_HEAD_DIMS = (16, 32, 64, 128)
_KERNEL_NAMES = {"inhibitor": "paged inhibitor", "flash": "paged attention"}


def split_refusal(family: str, group: int, d: int) -> Optional[str]:
    """Why the split kernel of ``family`` (``"inhibitor"`` or ``"flash"``,
    :func:`repro_torch.core.mechanism.kernel_family`) does not take
    ``group`` query heads per kv head at ``head_dim`` d, or None when it
    does (the planner asks before it plans ``paged_pallas``)."""
    if group > _SPLIT_MAX_GROUP or d not in _SPLIT_HEAD_DIMS:
        return (f"{_KERNEL_NAMES[family]} kernel: group {group} > "
                f"{_SPLIT_MAX_GROUP} or head_dim {d} not in "
                f"{_SPLIT_HEAD_DIMS}")
    return None


def _decode_layout(q, k_pool, v_pool, block_tables, lengths):
    """Shape checks shared by both kernels; returns (batch, heads,
    kv_heads, d, page_size, table_width)."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"paged decode kernels are single-query: q must be "
                         f"(batch, 1, heads, d), got {tuple(q.shape)}")
    batch, _, heads, d = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"k_pool {tuple(k_pool.shape)} / v_pool "
                         f"{tuple(v_pool.shape)} must be equal "
                         f"(num_pages, page_size, kv_heads, d)")
    _, page_size, kv_heads, dk = k_pool.shape
    if dk != d or heads % kv_heads:
        raise ValueError(f"heads={heads} / kv_heads={kv_heads}, d={d} / "
                         f"pool d={dk} do not factor")
    if (block_tables.dim() != 2 or block_tables.shape[0] != batch
            or tuple(lengths.shape) != (batch,)):
        raise ValueError(
            f"block_tables {tuple(block_tables.shape)} / lengths "
            f"{tuple(lengths.shape)} do not match batch={batch}")
    return batch, heads, kv_heads, d, page_size, block_tables.shape[1]


def attention_splits(width: int, pages_per_step: int) -> int:
    """Blocks per (row, kv head) of either split kernel: one per
    ``pages_per_step`` table entries, at least one."""
    return max(1, -(-width // max(1, min(pages_per_step, width))))


def _launch(family: str, layout, q, k_pool, v_pool, block_tables, lengths,
            *, pages_per_step: int, scale: float, extra: tuple, window):
    """Validate and launch one split kernel (and its merge) on the current
    stream of q's device; returns the output tensor.  ``layout`` is
    :func:`_decode_layout`'s."""
    from repro_torch.kernels import cuda_lib

    batch, heads, kv_heads, d, ps, width = layout
    name = _KERNEL_NAMES[family]
    tensors = (q, k_pool, v_pool, block_tables, lengths)
    dev = q.get_device()                       # -1 on the CPU
    if not q.is_cuda or any(t.get_device() != dev for t in tensors):
        raise ValueError(f"{name} kernel: all operands must be on one "
                         f"CUDA device, got {[str(t.device) for t in tensors]}")
    if q.dtype not in _DTYPE_CODE or k_pool.dtype != q.dtype or (
            v_pool.dtype != q.dtype):
        raise TypeError(f"{name} kernel: q/k_pool/v_pool must share "
                        f"one of {list(_DTYPE_CODE)}, got {q.dtype}, "
                        f"{k_pool.dtype}, {v_pool.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"{name} kernel: block_tables and lengths must be "
                        "int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel: operands must be contiguous")
    why = split_refusal(family, heads // kv_heads, d)
    if why:
        raise ValueError(why)
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError(f"{name} kernel: q and the pools must be 16-byte "
                         "aligned")
    pps = max(1, min(int(pages_per_step), width))
    n_splits = attention_splits(width, pps)
    lib = cuda_lib.library()
    out = torch.empty_like(q)
    if batch == 0:
        return out
    # float32 partials of every (row, head, split): the inhibitor's sums,
    # the Softmax's (m, l, acc)
    per_split = d if family == "inhibitor" else d + 2
    part = (torch.empty(batch * heads * n_splits * per_split,
                        dtype=torch.float32, device=q.device)
            if n_splits > 1 else None)
    entry = ("paged_inhibitor_decode" if family == "inhibitor"
             else "paged_attention_decode")
    err = cuda_lib.call_on_stream(
        dev, getattr(lib, entry), _DTYPE_CODE[q.dtype], q.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), batch, heads, kv_heads, d, ps,
        width, pps, float(scale), *extra,
        -1 if window is None else int(window),
        None if part is None else part.data_ptr())
    if err:
        raise RuntimeError(f"{entry} launch failed: "
                           f"{lib.paged_decode_error_string(err).decode()}")
    return out


# ---------------------------------------------------------------------------
# paged inhibitor decode
# ---------------------------------------------------------------------------

def paged_flash_inhibitor_plain(q, k_pool, v_pool, block_tables, lengths, *,
                                score_scale=None, score_shift=0.5,
                                signed=True, normalize=True, window=None):
    """Plain version of the paged inhibitor kernel (gather + fused)."""
    paged_flash_inhibitor_plain.calls += 1
    return kref.paged_flash_inhibitor_ref(
        q, k_pool, v_pool, block_tables, lengths, score_scale=score_scale,
        score_shift=score_shift, signed=signed, normalize=normalize,
        window=window)


paged_flash_inhibitor_plain.calls = 0


def paged_flash_inhibitor_fwd(
    q: torch.Tensor,              # (batch, 1, heads, d)
    k_pool: torch.Tensor,         # (num_pages, page_size, kv_heads, d)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,   # (batch, P) int32
    lengths: torch.Tensor,        # (batch,) int32 per-row cursors
    *,
    score_scale: Optional[float] = None,
    score_shift: float = 0.5,
    signed: bool = True,
    normalize: bool = True,
    window: Optional[int] = None,
    pages_per_step: Optional[int] = None,
) -> torch.Tensor:
    """Block-table-native paged inhibitor decode -> (batch, 1, heads, d),
    split over pages: ``pages_per_step`` is the pages per split."""
    layout = _decode_layout(q, k_pool, v_pool, block_tables, lengths)
    if q.device.type == "cpu":
        return paged_flash_inhibitor_plain(
            q, k_pool, v_pool, block_tables, lengths,
            score_scale=score_scale, score_shift=score_shift, signed=signed,
            normalize=normalize, window=window)
    scale = score_scale if score_scale is not None else math.sqrt(q.shape[-1])
    out = _launch("inhibitor", layout, q, k_pool, v_pool,
                  block_tables, lengths, pages_per_step=pages_per_step
                  or DEFAULT_PAGES_PER_STEP, scale=scale,
                  extra=(float(score_shift), int(bool(signed)),
                         int(bool(normalize))), window=window)
    paged_flash_inhibitor_fwd.launches += 1
    return out


paged_flash_inhibitor_fwd.launches = 0


# ---------------------------------------------------------------------------
# paged Softmax decode
# ---------------------------------------------------------------------------

def paged_flash_attention_plain(q, k_pool, v_pool, block_tables, lengths, *,
                                score_scale=None, window=None):
    """Plain version of the paged Softmax kernel (gather + fused)."""
    paged_flash_attention_plain.calls += 1
    return kref.paged_flash_attention_ref(
        q, k_pool, v_pool, block_tables, lengths, score_scale=score_scale,
        window=window)


paged_flash_attention_plain.calls = 0


def paged_flash_attention_fwd(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    score_scale: Optional[float] = None,
    window: Optional[int] = None,
    pages_per_step: Optional[int] = None,
) -> torch.Tensor:
    """Block-table-native paged Softmax decode -> (batch, 1, heads, d),
    split over pages: ``pages_per_step`` is the pages per split."""
    layout = _decode_layout(q, k_pool, v_pool, block_tables, lengths)
    if q.device.type == "cpu":
        return paged_flash_attention_plain(
            q, k_pool, v_pool, block_tables, lengths,
            score_scale=score_scale, window=window)
    scale = score_scale if score_scale is not None else math.sqrt(q.shape[-1])
    out = _launch("flash", layout, q, k_pool, v_pool,
                  block_tables, lengths, pages_per_step=pages_per_step
                  or DEFAULT_PAGES_PER_STEP, scale=scale, extra=(),
                  window=window)
    paged_flash_attention_fwd.launches += 1
    return out


paged_flash_attention_fwd.launches = 0


def reset_counts() -> None:
    """Zero every launch and plain-call count."""
    paged_flash_inhibitor_fwd.launches = 0
    paged_flash_attention_fwd.launches = 0
    paged_flash_inhibitor_plain.calls = 0
    paged_flash_attention_plain.calls = 0


def counts() -> dict:
    return {
        "paged_inhibitor": paged_flash_inhibitor_fwd.launches,
        "paged_attention": paged_flash_attention_fwd.launches,
        "paged_inhibitor_plain": paged_flash_inhibitor_plain.calls,
        "paged_attention_plain": paged_flash_attention_plain.calls,
    }
