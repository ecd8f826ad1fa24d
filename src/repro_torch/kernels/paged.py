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
float32 operations per byte, below the card's FP32 ridge point), about
1.1 MB at the serve shape: at that size a launch and a chain of
dependent loads, not the bytes, set the time.

* The inhibitor: one block per (row, kv head) walks the row's pages,
  ``pages_per_step`` at a time staged in shared memory.
* The Softmax is split over pages (flash-decoding): one block of 4 warps
  per (row, kv head, split), ``n_splits = ceil(table_width /
  pages_per_step)`` fixed from the table width (the host never reads
  ``lengths``; the serve tick keeps its 2 h2d + 1 d2h copies).  A block
  whose split holds no attendable key writes an empty partial (m =
  -1e30, l = 0) and exits; the others read K and V rows 16 bytes a lane
  straight from the pool (no shared-memory staging), reduce each key's
  dot over its lanes by shuffles and keep the online softmax in
  registers.  With more than one split a second small kernel rescales
  the float32 partials (scratch from ``torch.empty``) to their common max
  and writes ``acc / max(l, 1e-20)``; a row of length 0 writes 0.  Both
  launches count as one in ``paged_flash_attention_fwd.launches``.  What
  stands between it and its bound: the merge's second launch, the
  dependent-load latency inside a split, the launch itself.

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

import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import ref as kref

DEFAULT_PAGES_PER_STEP = 4

#: Platforms (tensor device types) these kernels run natively on.
LOWERS_ON = ("cuda",)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_THREADS = 1024
_MAX_SMEM = 227 * 1024
# the split Softmax keeps q and the sums of each of the group's heads in
# registers (one instantiation per group), and each lane loads 16 bytes
# of a key row
_SPLIT_MAX_GROUP = 8
_SPLIT_HEAD_DIMS = (16, 32, 64, 128)


def split_refusal(group: int, d: int) -> Optional[str]:
    """Why the split Softmax kernel does not take ``group`` query heads
    per kv head at ``head_dim`` d, or None when it does (the planner asks
    before it plans ``paged_pallas``)."""
    if group > _SPLIT_MAX_GROUP or d not in _SPLIT_HEAD_DIMS:
        return (f"paged attention kernel: group {group} > "
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
    """Blocks per (row, kv head) of the split Softmax: one per
    ``pages_per_step`` table entries, at least one."""
    return max(1, -(-width // max(1, min(pages_per_step, width))))


@functools.lru_cache(maxsize=None)
def _launch_config(entry: str, group: int, d: int, ps: int,
                   pages_per_step: int, width: int):
    """(pages per step, n_splits) of one kernel at one shape; raises on a
    shape the kernel does not take.  The inhibitor halves its staging
    depth until the pages fit shared memory; the Softmax splits the table
    into ceil(width / pages per split) blocks.  Memoized: the serve path
    asks 30 times a tick at one shape."""
    if group * d > _MAX_THREADS:
        raise ValueError(f"paged decode kernel: group*head_dim={group * d} "
                         f"exceeds {_MAX_THREADS} threads per block")
    pps = max(1, min(pages_per_step, width))
    if entry == "paged_attention_decode":
        why = split_refusal(group, d)
        if why:
            raise ValueError(why)
        return pps, attention_splits(width, pps)
    from repro_torch.kernels import cuda_lib

    lib = cuda_lib.library()
    while pps > 1 and lib.paged_decode_smem_bytes(group, d, ps,
                                                  pps) > _MAX_SMEM:
        pps //= 2
    smem = lib.paged_decode_smem_bytes(group, d, ps, pps)
    if smem > _MAX_SMEM:
        raise ValueError(f"paged decode kernel: {smem} bytes of shared "
                         f"memory (page_size={ps}, pages_per_step={pps}) "
                         f"exceed {_MAX_SMEM}")
    return pps, 1


def _launch(entry: str, layout, q, k_pool, v_pool, block_tables, lengths,
            *, pages_per_step: int, scale: float, extra: tuple, window):
    """Validate and launch one kernel on the current stream of q's device;
    returns the output tensor.  ``layout`` is :func:`_decode_layout`'s."""
    from repro_torch.kernels import cuda_lib

    batch, heads, kv_heads, d, ps, width = layout
    tensors = (q, k_pool, v_pool, block_tables, lengths)
    dev = q.get_device()                       # -1 on the CPU
    if not q.is_cuda or any(t.get_device() != dev for t in tensors):
        raise ValueError("paged decode kernel: all operands must be on one "
                         f"CUDA device, got {[str(t.device) for t in tensors]}")
    if q.dtype not in _DTYPE_CODE or k_pool.dtype != q.dtype or (
            v_pool.dtype != q.dtype):
        raise TypeError(f"paged decode kernel: q/k_pool/v_pool must share "
                        f"one of {list(_DTYPE_CODE)}, got {q.dtype}, "
                        f"{k_pool.dtype}, {v_pool.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged decode kernel: block_tables and lengths must "
                        "be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged decode kernel: operands must be contiguous")
    pps, n_splits = _launch_config(entry, heads // kv_heads, d, ps,
                                   int(pages_per_step), width)
    split = entry == "paged_attention_decode"
    if split and any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("paged attention kernel: q and the pools must be "
                         "16-byte aligned")
    lib = cuda_lib.library()
    out = torch.empty_like(q)
    if batch == 0:
        return out
    scratch = ()
    if split:
        # partials (m, l, acc) of every (row, head, split), float32
        part = (torch.empty(batch * heads * n_splits * (d + 2),
                            dtype=torch.float32, device=q.device)
                if n_splits > 1 else None)
        scratch = (None if part is None else part.data_ptr(),)
    err = cuda_lib.call_on_stream(
        dev, getattr(lib, entry), _DTYPE_CODE[q.dtype], q.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), batch, heads, kv_heads, d, ps,
        width, pps, float(scale), *extra,
        -1 if window is None else int(window), *scratch)
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
    """Block-table-native paged inhibitor decode -> (batch, 1, heads, d)."""
    layout = _decode_layout(q, k_pool, v_pool, block_tables, lengths)
    if q.device.type == "cpu":
        return paged_flash_inhibitor_plain(
            q, k_pool, v_pool, block_tables, lengths,
            score_scale=score_scale, score_shift=score_shift, signed=signed,
            normalize=normalize, window=window)
    scale = score_scale if score_scale is not None else math.sqrt(q.shape[-1])
    out = _launch("paged_inhibitor_decode", layout, q, k_pool, v_pool,
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
    out = _launch("paged_attention_decode", layout, q, k_pool, v_pool,
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
