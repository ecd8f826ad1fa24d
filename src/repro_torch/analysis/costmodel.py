"""The card's cost table and an analytic cost model of torch programs.

Port of :mod:`repro.analysis.costmodel`.  The reference walks a jaxpr;
the port walks the aten operations a torch function dispatches:

* :func:`torch_costs` runs a function under :class:`CostMode`, a
  ``TorchDispatchMode``, on ``meta`` tensors (no data, no card: shapes
  and dtypes only) and tallies FLOPs and an HBM-byte upper bound per
  aten operation.  Python loops unroll under tracing, so a loop of T
  steps is charged T times and there is no ``scan`` or ``cond``
  primitive to multiply or branch (``unbounded_loops`` stays 0; it is
  kept so the records equal the reference's keys).  The byte count is
  the unfused sum of operand and result bytes (an upper bound), except:
  gathers (``index_select``, ``gather``, ``index.Tensor``, ``embedding``)
  are charged their moved rows and the index bytes, never the whole
  pool (the reference's rule), scatters (``index_put_``, ``index_copy_``,
  ``scatter_`` ...) their updates and the index bytes, copies (``clone``,
  ``copy_``, ``cat`` ...) twice their output, and views (which move
  nothing in torch) and ``empty`` allocations nothing.  Reductions cost
  one FLOP per input element, matrix products 2·m·n·k, every other
  operation one FLOP per output element.  A host synchronisation inside
  the function (``aten._local_scalar_dense``, i.e. ``.item()``, or a
  device-to-CPU copy such as ``.cpu()`` / ``.tolist()``) is counted in
  ``host_callbacks`` and answered with zeros, so the walk goes on.
* The CUDA kernels launch through ctypes (``kernels.cuda_lib``) and
  cannot run on ``meta`` tensors: on ``meta`` the planner plans the plain
  path (the platform is ``"meta"``, where no kernel is native), so the
  walk charges the plain version's operations where the card launches a
  kernel, as the reference's CPU walk charges the interpret-mode kernel
  body.  Callers record which backend they walked.
  (``FakeTensorMode`` does fake ``cuda`` tensors on a host with no card,
  but the planner would then plan the kernels, which cannot launch on
  fake storage.)
* :func:`kernel_prior` / :func:`rank_kernel_candidates` — a static
  time prior for the kernel registry's candidates (``kernels.ops``), so
  the timed autotune walks them cheapest first and skips a candidate
  the kernel refuses.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import paged as kpaged


@dataclasses.dataclass(frozen=True)
class Platform:
    """Peak numbers for one card, used by the static rooflines."""

    name: str
    peak_flops: float        # dense bf16 tensor-core FLOP/s
    fp32_flops: float        # CUDA-core float32 FLOP/s (an FMA counts 2)
    hbm_bw: float            # HBM bandwidth, bytes/s
    link_bw: float           # card-to-card interconnect, bytes/s a direction
    h2d_bw: float            # host<->device link, bytes/s a direction
    dispatch_s: float        # fixed cost of one kernel launch
    smem_bytes: int          # shared memory one block may hold


#: NVIDIA H100 SXM5 80 GB (the card the port is measured on: "NVIDIA
#: H100 80GB HBM3, 700.00 W" by ``nvidia-smi --query-gpu=name,
#: power.limit``).  Sources: the H100 data sheet for peak_flops (989 TFLOP
#: /s dense bf16 on the tensor cores), fp32_flops (67 TFLOP/s), hbm_bw
#: (3.35 TB/s HBM3), link_bw (NVLink 4, 900 GB/s both directions: 450
#: GB/s each way) and h2d_bw (PCIe Gen5 x16, 128 GB/s both directions: 64
#: GB/s each way); the CUDA programming guide (compute capability 9.0)
#: for smem_bytes (227 KB of shared memory per block); dispatch_s
#: measured on that card by ``chip_smoke.py --only serve_analysis``: the
#: device time per kernel of 1,000 one-element kernels captured in one
#: CUDA graph and replayed (the engine's decode tick is such a replay),
#: 1.0056e-6 s (the same kernels launched eagerly: 1.17e-5 s each, host
#: included).
H100_SXM = Platform(
    name="h100-sxm5-80gb",
    peak_flops=989e12,
    fp32_flops=67e12,
    hbm_bw=3.35e12,
    link_bw=450e9,
    h2d_bw=64e9,
    dispatch_s=1.0056e-6,
    smem_bytes=227 * 1024,
)

DEFAULT_PLATFORM = H100_SXM


# --------------------------------------------------------------------------
# walking the aten operations of a torch function
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Costs:
    """Accumulated static costs of one walked function.  ``by_op`` maps
    an aten operation's name to [calls, FLOPs, bytes]."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    host_callbacks: int = 0      # .item() / device->CPU copies: host syncs
    unbounded_loops: int = 0     # always 0: Python loops unroll
    by_op: Dict[str, List[float]] = dataclasses.field(default_factory=dict)

    def charge(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.hbm_bytes += nbytes
        rec = self.by_op.setdefault(name, [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes

    def flops_of(self, names: Sequence[str]) -> float:
        """FLOPs charged to the aten operations ``names``."""
        return sum(self.by_op.get(n, (0, 0.0, 0.0))[1] for n in names)


#: matrix products: 2 FLOPs (multiply, add) per multiply-accumulate
MATMUL_OPS = ("mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot")

_GATHER_LIKE = frozenset({"index_select", "gather", "index", "embedding",
                          "take"})
_SCATTER_LIKE = frozenset({
    "index_put", "index_put_", "_index_put_impl_", "index_copy",
    "index_copy_", "scatter", "scatter_", "scatter_add", "scatter_add_",
    "scatter_reduce", "scatter_reduce_", "index_add", "index_add_",
})
#: operations that copy data without arithmetic: 2 x output bytes
_DATA_MOVEMENT = frozenset({
    "clone", "copy", "copy_", "_to_copy", "cat", "stack",
    "constant_pad_nd", "repeat", "contiguous", "expand_copy",
    "permute_copy", "flip", "roll",
})
#: operations that move nothing: views (also caught by ``is_view``) and
#: uninitialised allocations
_FREE = frozenset({
    "view", "_unsafe_view", "reshape", "alias", "detach", "t", "transpose",
    "permute", "expand", "slice", "select", "unsqueeze", "squeeze",
    "as_strided", "unfold", "split", "split_with_sizes", "unbind", "chunk",
    "diagonal", "narrow", "lift_fresh", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "_reshape_alias",
    "view_as",
})
#: reductions: one FLOP per input element
_REDUCTIONS = frozenset({
    "sum", "mean", "amax", "amin", "argmax", "argmin", "prod", "cumsum",
    "cumprod", "logsumexp", "norm", "linalg_vector_norm", "var", "std",
    "var_mean", "std_mean", "any", "all", "max", "min", "_softmax",
    "_log_softmax", "topk", "sort",
})


def _tensors(x) -> List[Any]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    if isinstance(x, dict):
        return [t for item in x.values() for t in _tensors(item)]
    return []


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _matmul_flops(name: str, tensors) -> float:
    if name in ("mm", "addmm"):
        a, b = tensors[-2:]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if name in ("bmm", "baddbmm"):
        a, b = tensors[-2:]
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name in ("mv", "addmv"):
        a = tensors[-2]
        return 2.0 * a.shape[0] * a.shape[1]
    return 2.0 * tensors[0].numel()                  # dot


def _host_sync(func, args, kwargs) -> bool:
    name = func.overloadpacket.__name__
    if name == "_local_scalar_dense":
        return True
    if name == "_to_copy" and args and kwargs.get("device") is not None:
        return (torch.device(kwargs["device"]).type == "cpu"
                and args[0].device.type != "cpu")
    if name == "copy_" and len(args) > 1:
        return args[0].device.type == "cpu" and args[1].device.type != "cpu"
    return False


def _host_answer(func, args, kwargs):
    """What a host sync returns in the walk: zeros, on the CPU."""
    if func.overloadpacket.__name__ == "_local_scalar_dense":
        t = args[0]
        return False if t.dtype == torch.bool else (
            0.0 if t.is_floating_point() else 0)
    if func.overloadpacket.__name__ == "copy_":
        return args[0]
    return torch.zeros(args[0].shape, device="cpu",
                       dtype=kwargs.get("dtype") or args[0].dtype)


def _classify(func, args, out, costs: Costs) -> None:
    name = func.overloadpacket.__name__
    ins = _tensors(args)
    outs = _tensors(out)
    out_bytes = sum(_nbytes(t) for t in outs)
    out_elems = sum(t.numel() for t in outs)
    in_bytes = sum(_nbytes(t) for t in ins)
    if name in _FREE or getattr(func, "is_view", False):
        costs.charge(name, 0.0, 0.0)
    elif name in MATMUL_OPS:
        costs.charge(name, _matmul_flops(name, ins), in_bytes + out_bytes)
    elif name in _GATHER_LIKE:
        # the moved rows, read and written, and the indices: never the
        # whole table / pool (its first operand)
        idx = sum(_nbytes(t) for t in ins[1:]) if name != "embedding" \
            else _nbytes(ins[1])
        costs.charge(name, 0.0, 2.0 * out_bytes + idx)
    elif name in _SCATTER_LIKE:
        if len(ins) >= 3:
            upd, idx = _nbytes(ins[-1]), sum(_nbytes(t) for t in ins[1:-1])
        else:                       # a scalar source: one value per index
            idx = sum(_nbytes(t) for t in ins[1:])
            upd = sum(t.numel() for t in ins[1:]) * ins[0].element_size()
        costs.charge(name, 0.0, 2.0 * upd + idx)
    elif name in _DATA_MOVEMENT:
        costs.charge(name, 0.0, 2.0 * out_bytes)
    elif name in _REDUCTIONS and not (
            name in ("max", "min") and func._overloadname == "other"):
        costs.charge(name, float(ins[0].numel()) if ins else 0.0,
                     in_bytes + out_bytes)
    else:                           # elementwise
        costs.charge(name, float(out_elems), in_bytes + out_bytes)


class CostMode(TorchDispatchMode):
    """Tallies :class:`Costs` over every aten operation dispatched while
    it is active (``with CostMode() as m: ...``; then ``m.costs``); host
    syncs are counted and answered with zeros instead of run."""

    def __init__(self):
        super().__init__()
        self.costs = Costs()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _host_sync(func, args, kwargs):
            self.costs.host_callbacks += 1
            return _host_answer(func, args, kwargs)
        out = func(*args, **kwargs)
        _classify(func, args, out, self.costs)
        return out


def to_meta(tree):
    """The same nesting with every tensor replaced by a ``meta`` tensor
    of its shape and dtype (NamedTuples, lists and dicts kept)."""
    if isinstance(tree, torch.Tensor):
        return torch.empty_like(tree, device="meta")
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_meta(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_meta(v) for v in tree)
    return tree


def torch_costs(fn: Callable, *args, **kwargs) -> Costs:
    """Static costs of ``fn(*args, **kwargs)``, run under
    :class:`CostMode`.  Pass ``meta`` tensors (:func:`to_meta`) to walk
    without data or a card."""
    with torch.no_grad(), CostMode() as mode:
        fn(*args, **kwargs)
    return mode.costs


def roofline(costs: Costs, platform: Platform = DEFAULT_PLATFORM, *,
             transfer_bytes: float = 0.0) -> Dict[str, Any]:
    """Roofline estimate for one walked function on one platform."""
    compute_s = costs.flops / platform.peak_flops
    memory_s = costs.hbm_bytes / platform.hbm_bw
    transfer_s = transfer_bytes / platform.h2d_bw
    bound = max(
        (("compute", compute_s), ("memory", memory_s),
         ("transfer", transfer_s)),
        key=lambda kv: kv[1])[0]
    return {
        "flops": costs.flops,
        "hbm_bytes": costs.hbm_bytes,
        "transfer_bytes": transfer_bytes,
        "host_callbacks": costs.host_callbacks,
        "unbounded_loops": costs.unbounded_loops,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "transfer_s": transfer_s,
        "est_s": max(compute_s, memory_s) + transfer_s,
        "bound": bound,
    }


# --------------------------------------------------------------------------
# kernel-candidate static priors (the kernel registry's autotune)
# --------------------------------------------------------------------------

#: float32 work per (query head, attended key, head dim) element of the
#: split paged kernels: the inhibitor's four CUDA-core instructions (|q -
#: k| and its sum, min(|v|, z) and the signed fma), the Softmax's two
#: FMAs (q.k and p.v, four FLOPs)
_PAGED_OPS = {"inhibitor": 4.0, "flash": 4.0}


def kernel_prior(family: str, shape_key: Sequence, choice,
                 platform: Platform = DEFAULT_PLATFORM) -> float:
    """Static time prior (seconds) of one launch choice for one row.

    ``choice`` is duck-typed (``block_q`` / ``block_k`` /
    ``pages_per_step``, any may be None), so this module does not import
    the registry.  It prices what the port's CUDA kernels launch, whose
    blocks run in parallel (a grid's size costs no dispatches): for the
    ``paged`` family (``shape_key`` = (kernel family, table width,
    page_size, heads, kv_heads, head_dim)) the split kernel and, with
    more than one split, its merge (one dispatch each), the K/V bytes of
    the table read once, the float32 partials written and merged, and
    the arithmetic at the CUDA-core float32 rate.  Returns ``inf`` for a
    candidate the kernel refuses (``kernels.paged.split_refusal``) or
    whose block needs more shared memory than the platform's per-block
    limit."""
    if family == "paged":
        fam, pages, page_size, h, h_kv, d = shape_key
        group = h // max(h_kv, 1)
        if kpaged.split_refusal(fam, group, d) is not None:
            return math.inf
        if kpaged.split_smem_bytes(fam, group, d) > platform.smem_bytes:
            return math.inf
        pps = getattr(choice, "pages_per_step", None) or \
            kpaged.DEFAULT_PAGES_PER_STEP
        splits = kpaged.attention_splits(pages, pps)
        launches = 1 + (splits > 1)
        kv_bytes = 2.0 * pages * page_size * h_kv * d * 4
        per_split = d if fam == "inhibitor" else d + 2
        partial_bytes = 2.0 * h * splits * per_split * 4 if splits > 1 else 0
        ops = _PAGED_OPS[fam] * pages * page_size * h * d
        return (launches * platform.dispatch_s
                + (kv_bytes + partial_bytes) / platform.hbm_bw
                + ops / platform.fp32_flops)

    # the blockwise prefill kernels ("inhibitor" / "flash"): one launch;
    # each query tile streams every key tile of its span once
    n_q, n_k, h, h_kv, d = shape_key[:5]
    causal = bool(shape_key[5]) if len(shape_key) > 5 else False
    bq = getattr(choice, "block_q", None) or 64
    bk = getattr(choice, "block_k", None) or 64
    smem = (bq * d + 2 * bk * d) * 4
    if smem > platform.smem_bytes:
        return math.inf
    frac = 0.5 if (causal and n_q == n_k) else 1.0
    q_steps = math.ceil(n_q / bq)
    kv_bytes = frac * q_steps * 2.0 * n_k * h_kv * d * 4
    flops = frac * 4.0 * n_q * n_k * h * d
    rate = platform.fp32_flops if family == "inhibitor" else \
        platform.peak_flops
    return platform.dispatch_s + kv_bytes / platform.hbm_bw + flops / rate


def rank_kernel_candidates(family: str, shape_key: Sequence,
                           candidates: Sequence,
                           platform: Platform = DEFAULT_PLATFORM,
                           ) -> List[Tuple[Any, float]]:
    """Candidates with their priors, cheapest first.  The sort is stable:
    equal priors (a run of ``inf`` included) keep their declared order,
    so the registry's default stays first where the model has no
    opinion."""
    priced = [(c, kernel_prior(family, shape_key, c, platform))
              for c in candidates]
    return sorted(priced, key=lambda cp: cp[1])
