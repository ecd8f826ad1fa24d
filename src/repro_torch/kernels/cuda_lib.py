"""Build and load the port's CUDA kernels.

The sources under ``repro_torch/csrc/`` (the paged decode kernels, the
blockwise flash forward kernels and the RWKV-6 WKV scan) are compiled
with ``nvcc`` for ``sm_90a`` into one shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  Each source compiles to an object in its own ``nvcc``
process, all started together, and one more links them.  The library
is built at first use into ``build/kernels/`` at the repository root,
keyed by a hash of the sources and flags, and reused while they are
unchanged.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
SOURCES = (_PKG / "csrc" / "paged_decode.cu",
           _PKG / "csrc" / "flash_prefill.cu",
           _PKG / "csrc" / "wkv6.cu")
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float        # nvcc wall time (0.0 when reused)
    cached: bool          # the library for these sources already existed
    log: str              # nvcc / ptxas output (registers, shared memory)


_lib: Optional[ctypes.CDLL] = None
_build: Optional[BuildInfo] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile the kernel library unless it exists for these sources."""
    global _build
    if _build is not None:
        return _build
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"libkernels-{_digest()}.so"
    if target.is_file():
        _build = BuildInfo(target, 0.0, True, "")
        return _build
    nvcc = _nvcc()
    tag = f"{target.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}-{tag}.o" for src in SOURCES]
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    failed = [(src.name, p.returncode) for src, p in zip(SOURCES, procs)
              if p.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            failed.append(("link", link.returncode))
    for obj in objs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed {failed}:\n{log}")
    os.replace(tmp, target)
    (BUILD_DIR / f"{target.stem}.log").write_text(log)
    _build = BuildInfo(target, seconds, False, log)
    return _build


def call_on_stream(device_index: int, entry, *args) -> int:
    """``entry(*args, stream)`` with the current stream of CUDA device
    ``device_index``, made the current device for the call when it is not
    already: the raw stream handle and the device test are cheaper on the
    host than a ``torch.cuda.Stream`` and a device context, which would
    outweigh the launch of a kernel of a few microseconds."""
    import torch

    if device_index == torch.cuda.current_device():
        return entry(*args, torch._C._cuda_getCurrentRawStream(device_index))
    with torch.cuda.device(device_index):
        return entry(*args, torch._C._cuda_getCurrentRawStream(device_index))


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build().path))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_inhibitor_decode.argtypes = [
        I, P, P, P, P, P, P, I, I, I, I, I, I, I, F, F, I, I, I, P, P]
    lib.paged_inhibitor_decode.restype = I
    lib.paged_attention_decode.argtypes = [
        I, P, P, P, P, P, P, I, I, I, I, I, I, I, F, I, P, P]
    lib.paged_attention_decode.restype = I
    lib.flash_inhibitor_prefill.argtypes = [
        I, P, P, P, P, P, I, I, I, I, I, I, I, F, F, I, I, I, I, P]
    lib.flash_inhibitor_prefill.restype = I
    lib.flash_attention_prefill.argtypes = [
        I, P, P, P, P, P, I, I, I, I, I, I, I, F, I, I, P]
    lib.flash_attention_prefill.restype = I
    lib.flash_prefill_smem_bytes.argtypes = [I, I, I]
    lib.flash_prefill_smem_bytes.restype = ctypes.c_longlong
    lib.flash_prefill_max_outputs.argtypes = []
    lib.flash_prefill_max_outputs.restype = I
    lib.wkv6_chunked_fwd.argtypes = [I, P, P, P, P, P, P, P, I, I, I, I, I, P]
    lib.wkv6_chunked_fwd.restype = I
    lib.paged_decode_error_string.argtypes = [I]
    lib.paged_decode_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib
