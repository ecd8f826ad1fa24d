"""Flash-Inhibitor: the blockwise inhibitor forward (eq. 5 + eq. 9/10).

:func:`flash_inhibitor_fwd` launches the hand-written CUDA kernel of
``csrc/flash_prefill.cu``, which replaces the TPU kernel
``repro/kernels/inhibitor.py:99`` ``_flash_inhibitor_kernel``: one block
of 4 warps per (row, query head, tile of 64 queries) loops over 64-key
tiles of K and V, double-buffered in shared memory by ``cp.async``.  Each
thread sums |q - k| over head_dim for a register micro-tile of 8 queries
x 4 keys, then adds ``v - sgn(v) min(|v|, z)`` (the signed eq. 10 term
by term; ``v - min(v, z)`` unsigned) for head_dim / 8 queries x 4 dims:
about four float32 instructions per (query head, attended key, d), none
of them a product the tensor cores could take.  Masks (causal, window,
cursors) are applied only on tiles that need them, as z = +inf, with the
term in the form ``sgn(v) relu(|v| - z)`` that adds an exact 0 there;
keys past a cursor enter shared memory as zeros and are never read.  The
source's header note gives the bound and the design.

:func:`flash_inhibitor_plain` is its plain version: the chunked streaming
form of :mod:`repro_torch.core.inhibitor` under the same mask (exact; its
cubes are bounded by the key chunk, so it runs at the training shapes).
The wrapper takes it only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises, never falls back.  ``<wrapper>.launches``
counts kernel launches and ``<plain>.calls`` plain calls
(:func:`reset_counts` zeroes both, with :mod:`repro_torch.kernels.flash`'s).

``q_offset`` / ``kv_valid_len`` (the decode-cache form): queries of row r
sit at positions ``q_offset[r] + i`` and only its first ``kv_valid_len[r]``
keys are live (:func:`pack_cursors`).

:func:`flash_inhibitor_bwd` is the training form's backward: on the card
the two-pass kernel of ``csrc/flash_inhibitor_bwd.cu`` (pass A dk and dv
per 64-key tile over the group's query heads, pass B dq per 64-query
tile, each recomputing the scores; no atomics), on the CPU its plain
version :func:`flash_inhibitor_bwd_plain`, the reference's analytic VJP.
It counts launches and plain calls the same way.
"""

from __future__ import annotations

import functools
import math
import numbers
from typing import Optional

import torch

from repro_torch.kernels import ref as kref

BLOCK_Q = 64                  # queries per block (fixed by the micro-tiles)
BLOCK_K = 64                  # keys per staged tile
PLAIN_KV_CHUNK = 128

#: Platforms (tensor device types) these kernels run natively on.
LOWERS_ON = ("cuda",)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_MAX_SMEM = 227 * 1024


def pack_cursors(batch: int, q_offset, kv_valid_len, n_k: int,
                 device) -> torch.Tensor:
    """Per-row decode cursors as one (2, batch) int32 tensor: row 0 the
    query offsets, row 1 the KV valid lengths.  Scalars broadcast;
    ``None`` means offset 0 / all ``n_k`` keys.  A Python scalar is
    filled on ``device`` (no host-to-device copy, which would wait for
    the card at every launch of a training entry's query slice)."""
    def one(x, default):
        x = default if x is None else x
        if isinstance(x, numbers.Integral):
            t = torch.full((), int(x), dtype=torch.int32, device=device)
        else:
            t = torch.as_tensor(x, dtype=torch.int32, device=device)
        return t.reshape(-1).expand(batch)

    return torch.stack([one(q_offset, 0), one(kv_valid_len, n_k)])


def _layout(q, k, v):
    """Shape checks shared by both prefill kernels; returns (batch, n_q,
    n_k, heads, kv_heads, d)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)} must be (batch, n_q, heads, d) "
                         f"and k {tuple(k.shape)} / v {tuple(v.shape)} equal "
                         f"(batch, n_k, kv_heads, d)")
    batch, n_q, heads, d = q.shape
    _, n_k, kv_heads, dk = k.shape
    if k.shape[0] != batch or dk != d or heads % kv_heads:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"factor into (batch, heads / kv_heads, d)")
    return batch, n_q, n_k, heads, kv_heads, d


@functools.lru_cache(maxsize=None)
def _block_q(group: int, d: int, block_q: int, tiles) -> int:
    """The query tile one launch takes: with ``tiles`` (a kernel of fixed
    tiles) ``block_q`` itself, else raises; without, ``block_q`` halved
    until the block's group * block_q * d outputs (held in registers) and
    its staged tiles fit.  Memoized per shape: the training step asks 60
    times at one shape."""
    if tiles is not None:
        if block_q not in tiles:
            raise ValueError(f"prefill kernel: block_q {block_q} is not one "
                             f"of this kernel's query tiles {tiles}")
        return block_q
    from repro_torch.kernels import cuda_lib

    lib = cuda_lib.library()
    bq = max(1, block_q)
    while bq > 1 and (group * bq * d > lib.flash_prefill_max_outputs()
                      or lib.flash_prefill_smem_bytes(group, bq, d)
                      > _MAX_SMEM):
        bq //= 2
    if (group * bq * d > lib.flash_prefill_max_outputs()
            or lib.flash_prefill_smem_bytes(group, bq, d) > _MAX_SMEM):
        raise ValueError(f"prefill kernel: group {group} x head_dim {d} "
                         f"does not fit one block")
    return bq


def _check_on_card(what: str, qkv, others=(), *, aligned: bool) -> None:
    """The card kernels' operand checks: every tensor on one CUDA device
    and contiguous, q / k / v (and whatever joins them, as the backward's
    g) of one supported dtype and head_dim, and with ``aligned`` (the
    kernels' 16-byte copies) each of them 16-byte aligned."""
    q = qkv[0]
    tensors = tuple(qkv) + tuple(others)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"{what}: all operands must be on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in qkv):
        raise TypeError(f"{what}: q/k/v must share one of "
                        f"{list(_DTYPE_CODE)}, got "
                        f"{', '.join(str(t.dtype) for t in qkv)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: operands must be contiguous")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {q.shape[-1]} not in "
                         f"{_HEAD_DIMS}")
    if aligned and any(t.data_ptr() % 16 for t in qkv):
        raise ValueError(f"{what}: q/k/v must be 16-byte aligned")


def launch_prefill(entry: str, q, k, v, cursors, *, block_q: int,
                   scale: float, extra: tuple, causal: bool, window,
                   tiles=None):
    """Validate and launch one prefill kernel on the current stream of q's
    device; returns the output tensor.  Shared by the flash inhibitor and
    flash attention wrappers (the two kernels take the same layout).
    ``tiles``: the query tiles a kernel of fixed tiles takes (its operands
    then must be 16-byte aligned, for its 16-byte copies); None for the
    float32 Softmax kernel, whose tile is halved to fit."""
    from repro_torch.kernels import cuda_lib

    batch, n_q, n_k, heads, kv_heads, d = _layout(q, k, v)
    if cursors is not None and (cursors.dtype != torch.int32
                                or tuple(cursors.shape) != (2, batch)):
        raise TypeError("prefill kernel: cursors must be (2, batch) int32")
    _check_on_card("prefill kernel", (q, k, v), () if cursors is None
                   else (cursors,), aligned=tiles is not None)
    bq = _block_q(heads // kv_heads, d, int(block_q), tiles)
    lib = cuda_lib.library()
    out = torch.empty_like(q)
    if batch == 0 or n_q == 0:
        return out
    err = cuda_lib.call_on_stream(
        q.get_device(), getattr(lib, entry), _DTYPE_CODE[q.dtype],
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if cursors is None else cursors.data_ptr(), out.data_ptr(),
        batch, n_q, n_k, heads, kv_heads, d, bq, float(scale), *extra,
        int(bool(causal)), -1 if window is None else int(window))
    if err:
        raise RuntimeError(f"{entry} launch failed: "
                           f"{lib.paged_decode_error_string(err).decode()}")
    return out


def _cursors_or_none(q, k, q_offset, kv_valid_len):
    if q_offset is None and kv_valid_len is None:
        return None
    return pack_cursors(q.shape[0], q_offset, kv_valid_len, k.shape[1],
                        q.device)


def flash_inhibitor_plain(q, k, v, *, score_scale=None, score_shift=0.5,
                          signed=True, normalize=True, causal=True,
                          window=None, q_offset=None, kv_valid_len=None):
    """Plain version of the flash inhibitor kernel: the chunked form under
    the kernel's mask."""
    flash_inhibitor_plain.calls += 1
    from repro_torch.core.inhibitor import inhibitor_attention_chunked

    mask = kref.prefill_mask(
        q.shape[1], k.shape[1], causal=causal, window=window,
        cursors=_cursors_or_none(q, k, q_offset, kv_valid_len),
        device=q.device)
    return inhibitor_attention_chunked(
        q, k, v, mask=mask, score_scale=score_scale, score_shift=score_shift,
        signed=signed, normalize=normalize, kv_chunk=PLAIN_KV_CHUNK)


flash_inhibitor_plain.calls = 0


def flash_inhibitor_fwd(
    q: torch.Tensor,            # (batch, n_q, heads, d)
    k: torch.Tensor,            # (batch, n_k, kv_heads, d)
    v: torch.Tensor,            # (batch, n_k, kv_heads, d)
    *,
    score_scale: Optional[float] = None,
    score_shift: float = 0.5,
    signed: bool = True,
    normalize: bool = True,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset=None,
    kv_valid_len=None,
) -> torch.Tensor:
    """Flash-inhibitor forward -> (batch, n_q, heads, d) in q.dtype.

    The ragged edge (n_q, n_k not multiples of the tiles) is masked inside
    the kernel: no padding copy.  ``q_offset`` / ``kv_valid_len`` (int,
    0-d or (batch,) tensors) select the decode-cache form.  On the card
    q, k, v must be 16-byte aligned (else ValueError)."""
    _layout(q, k, v)
    kw = dict(score_scale=score_scale, score_shift=score_shift,
              signed=signed, normalize=normalize, causal=causal,
              window=window)
    if q.device.type == "cpu":
        return flash_inhibitor_plain(q, k, v, q_offset=q_offset,
                                     kv_valid_len=kv_valid_len, **kw)
    scale = score_scale if score_scale is not None else math.sqrt(q.shape[-1])
    out = launch_prefill(
        "flash_inhibitor_prefill", q, k, v,
        _cursors_or_none(q, k, q_offset, kv_valid_len), block_q=BLOCK_Q,
        scale=scale, extra=(float(score_shift), int(bool(signed)),
                            int(bool(normalize))), causal=causal,
        window=window, tiles=(BLOCK_Q,))
    flash_inhibitor_fwd.launches += 1
    return out


flash_inhibitor_fwd.launches = 0


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------

def flash_inhibitor_bwd_plain(q, k, v, g, *, score_scale=None,
                              score_shift=0.5, signed=True, normalize=True,
                              causal=True, window=None, q_offset: int = 0):
    """Plain version of the backward kernel: the reference's analytic VJP
    (``core.inhibitor.inhibitor_attention_vjp``, key-chunked float32
    cubes) under ``kernels.ref.backward_mask``, which also sets each row's
    count of attended keys and the query rows each key chunk visits."""
    flash_inhibitor_bwd_plain.calls += 1
    from repro_torch.core.inhibitor import inhibitor_attention_vjp

    mask = kref.backward_mask(q, k, causal, window, q_offset)
    return inhibitor_attention_vjp(
        q, k, v, g, mask=mask, score_scale=score_scale,
        score_shift=score_shift, signed=signed, normalize=normalize)


flash_inhibitor_bwd_plain.calls = 0


def flash_inhibitor_bwd(
    q: torch.Tensor,            # (batch, n_q, heads, d)
    k: torch.Tensor,            # (batch, n_k, kv_heads, d)
    v: torch.Tensor,            # (batch, n_k, kv_heads, d)
    g: torch.Tensor,            # (batch, n_q, heads, d): the cotangent
    *,
    score_scale: Optional[float] = None,
    score_shift: float = 0.5,
    signed: bool = True,
    normalize: bool = True,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
):
    """(dq, dk, dv) of :func:`flash_inhibitor_fwd` (the training form: the
    queries at ``q_offset + i``, every key valid) for the output
    cotangent ``g``, in q's dtype.  On the card the two-pass kernel of
    ``csrc/flash_inhibitor_bwd.cu`` (deterministic: no atomics, dk and dv
    summed over the group's heads in order), on the CPU its plain
    version; a CUDA tensor launches the kernel or raises."""
    batch, n_q, n_k, heads, kv_heads, d = _layout(q, k, v)
    kw = dict(score_scale=score_scale, score_shift=score_shift,
              signed=signed, normalize=normalize, causal=causal,
              window=window, q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_inhibitor_bwd_plain(q, k, v, g, **kw)
    from repro_torch.kernels import cuda_lib

    if g.shape != q.shape:
        raise ValueError(f"backward kernel: g {tuple(g.shape)} must be "
                         f"shaped as q {tuple(q.shape)}")
    if not g.is_contiguous() or g.data_ptr() % 16:
        g = g.clone(memory_format=torch.contiguous_format)
    _check_on_card("backward kernel", (q, k, v, g), aligned=True)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if batch == 0 or n_q == 0 or n_k == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    gamma = score_scale if score_scale is not None else math.sqrt(d)
    lib = cuda_lib.library()
    err = cuda_lib.call_on_stream(
        q.get_device(), lib.flash_inhibitor_backward, _DTYPE_CODE[q.dtype],
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), batch, n_q, n_k, heads,
        kv_heads, d, 1.0 / gamma, float(score_shift), int(bool(signed)),
        int(bool(normalize)), int(bool(causal)),
        -1 if window is None else int(window), int(q_offset))
    if err:
        raise RuntimeError("flash_inhibitor_backward launch failed: "
                           f"{lib.paged_decode_error_string(err).decode()}")
    flash_inhibitor_bwd.launches += 1
    return dq, dk, dv


flash_inhibitor_bwd.launches = 0
