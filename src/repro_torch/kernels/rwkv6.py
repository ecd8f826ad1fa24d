"""RWKV-6 (Finch) WKV: the chunked scan from a zero state.

:func:`wkv6_chunked` launches the hand-written CUDA kernel of
``csrc/wkv6.cu``, which replaces the TPU kernel
``repro/kernels/rwkv6.py:43`` ``_wkv6_kernel``.  The TPU carries the
(n × n) state in VMEM scratch across a sequential grid axis; a CUDA block
cannot hand anything to another, so one block owns one (batch, head) row
and walks its chunks itself, the float32 state in its warps' tensor-core
accumulators for the whole sequence, and writes the final state once.
Within a chunk it computes what the TPU kernel computes (see :func:`repro_torch.nn.ssm.
wkv6_chunk`): the carry term through the state, the strictly lower
intra-chunk matrix with every exponent ≤ 0, the diagonal bonus, and the
state update, its products in 3xTF32 on the tensor cores.  The decay is
floored at 1e-30 before its log, and positions past ``t`` in the last
chunk have zero k, v and a log-decay of 0, so they add nothing to the
state: the kernel applies both by predicate as it loads a chunk, where
the TPU wrapper pads and floors in HBM.

:func:`wkv6_chunked_plain` is its plain version: the same chunk-carried
formula in torch (:func:`repro_torch.nn.ssm.wkv6_chunked_form`).  The
wrapper takes it only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises, never falls back.
``wkv6_chunked.launches`` counts kernel launches and
``wkv6_chunked_plain.calls`` plain calls.
"""

from __future__ import annotations

import torch

from repro_torch.nn.ssm import wkv6_chunked_form

DEFAULT_CHUNK = 32
MAX_CHUNK = 64                # positions per chunk the kernel stages

#: Platforms (tensor device types) this kernel runs natively on.
LOWERS_ON = ("cuda",)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (8, 16, 32, 64)


def _layout(r, k, v, w, u, chunk: int):
    """Shape checks shared by the kernel and its plain version; returns
    (batch, t, heads, head_dim)."""
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == w.shape):
        raise ValueError(f"r {tuple(r.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} and w {tuple(w.shape)} must all "
                         f"be (batch, t, heads, head_dim)")
    b, t, h, n = r.shape
    if tuple(u.shape) != (h, n):
        raise ValueError(f"u {tuple(u.shape)} must be (heads, head_dim) = "
                         f"{(h, n)}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} not in [1, {MAX_CHUNK}]")
    return b, t, h, n


def wkv6_chunked_plain(r, k, v, w, u, *, chunk: int = DEFAULT_CHUNK):
    """Plain version of the WKV kernel: the chunk-carried formula in
    torch.  Returns (out (b, t, h, n), final state (b, h, n, n)),
    float32."""
    wkv6_chunked_plain.calls += 1
    return wkv6_chunked_form(r, k, v, w, u, chunk=chunk)


wkv6_chunked_plain.calls = 0


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, *,
                 chunk: int = DEFAULT_CHUNK):
    """WKV6 from a zero state.  r, k, v: (b, t, h, n) in float32 or bf16
    (one dtype); w: (b, t, h, n) float32 decay in [0, 1]; u: (h, n) float32
    bonus.  Returns (out (b, t, h, n) float32, final state (b, h, n, n)
    float32)."""
    b, t, h, n = _layout(r, k, v, w, u, chunk)
    if r.device.type == "cpu":
        return wkv6_chunked_plain(r, k, v, w, u, chunk=chunk)
    from repro_torch.kernels import cuda_lib

    tensors = (r, k, v, w, u)
    if r.device.type != "cuda" or any(x.device != r.device for x in tensors):
        raise ValueError("wkv6 kernel: all operands must be on one CUDA "
                         f"device, got {[str(x.device) for x in tensors]}")
    if r.dtype not in _DTYPE_CODE or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv6 kernel: r/k/v must share one of "
                        f"{list(_DTYPE_CODE)}, got {r.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"wkv6 kernel: w and u must be float32, got "
                        f"{w.dtype}, {u.dtype}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("wkv6 kernel: operands must be contiguous")
    if n not in _HEAD_DIMS:
        raise ValueError(f"wkv6 kernel: head_dim {n} not in {_HEAD_DIMS}")
    out = torch.empty((b, t, h, n), dtype=torch.float32, device=r.device)
    state = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    if b * h == 0:
        return out, state
    lib = cuda_lib.library()
    err = cuda_lib.call_on_stream(
        r.get_device(), lib.wkv6_chunked_fwd, _DTYPE_CODE[r.dtype],
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        out.data_ptr(), state.data_ptr(), b, t, h, n, int(chunk))
    if err:
        raise RuntimeError(f"wkv6_chunked_fwd launch failed: "
                           f"{lib.paged_decode_error_string(err).decode()}")
    wkv6_chunked.launches += 1
    return out, state


wkv6_chunked.launches = 0
