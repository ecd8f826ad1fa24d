"""The yardstick's arithmetic: the H100's published peaks, the least time of
a kernel call from its shapes, and the least time of a whole step.

The peaks and ``bound`` / ``flash_bound`` are frozen copies of the kernel
bounds that ``chip_smoke.py`` has used since the port's kernels were
written, so that a later change to the program cannot move them.  A
least time is the larger of the bytes the work needs at the HBM rate and
the operations it needs at the unit's peak; a share of it (a roofline, an
``mfu``) is that least time over a measured time, and cannot pass 1.
"""

from __future__ import annotations

from typing import Optional, Sequence

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth,
# float32 outside the tensor cores (an FMA counted as two operations), bf16
# on the tensor cores (dense)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12
# float32 instructions that are not FMAs (add, max) issue at one per lane
# and cycle: 132 SMs x 128 lanes x 1.98 GHz boost, half the FMA rate above
FP32_INSTR_PER_S = 132 * 128 * 1.98e9
# float32 operations per (query head, attendable key, head dim) element.
# Softmax: two FMAs (q.k and p.v).  Both inhibitor kernels: instructions,
# the least that compute it: t = q - k and s += |t| for the score,
# m = min(|v|, z) and acc = fma(-sgn v, m, acc) for the inhibition.  The
# sum of v over the attended keys is shared by the query heads of a kv
# head: one add per (kv head, key, d) and one per (query head, query, d).
OPS_PER_ELEMENT = {"paged_inhibitor": 4, "paged_attention": 4,
                   "flash_inhibitor": 4, "flash_attention": 4}
# the paged kernels' page size, as the engine's pools are laid out
PAGE = 16


def _least(nbytes: float, ops: float, rate: float) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def bound(name: str, tables: Sequence[Sequence[int]],
          lengths: Sequence[int], *, heads: int, kv_heads: int, d: int,
          elem: int, window: Optional[int] = None,
          page: int = PAGE) -> dict:
    """Least time of one paged decode call (one query a row): K and V of
    each distinct (page, slot) position some row attends read once (rows
    sharing pages read them once between them), q read and out written
    once, the table entries walked and the lengths read once; the float32
    operations on the attendable keys of every query head (the
    inhibitor's as instructions, with the sum of v per kv head).
    ``tables[row]`` holds the row's pages, ``lengths[row]`` its keys."""
    positions, entries, ops = set(), 0, 0
    for row, ln in enumerate(lengths):
        lo = max(0, ln - window) if window is not None else 0
        positions.update((tables[row][j // page], j % page)
                         for j in range(lo, ln))
        entries += -(-ln // page) - lo // page
        ops += (ln - lo) * heads * d * OPS_PER_ELEMENT[name]
        if name == "paged_inhibitor":
            ops += (ln - lo) * kv_heads * d + heads * d
    n_rows = len(lengths)
    nbytes = (2 * len(positions) * kv_heads * d * elem
              + 2 * n_rows * heads * d * elem + 4 * entries + 4 * n_rows)
    rate = FP32_INSTR_PER_S if name == "paged_inhibitor" else FP32_OPS_PER_S
    return _least(nbytes, ops, rate)


def flash_bound(name: str, b: int, n: int, elem: int, heads: int,
                kv_heads: int, d: int, causal: bool = True) -> dict:
    """Least time of one prefill kernel call at (b, n), causal or not: q,
    k, v read and out written once; the operations on each attended
    (query head, key) pair: the inhibitor as float32 instructions that are
    not FMAs on the CUDA cores (no tensor core computes a sum of absolute
    differences), the Softmax products on the bf16 tensor cores (float32:
    FMAs on the CUDA cores)."""
    nbytes = elem * (2 * b * n * heads * d + 2 * b * n * kv_heads * d)
    pairs = b * heads * (n * (n + 1) // 2 if causal else n * n)
    ops = OPS_PER_ELEMENT[name] * pairs * d
    if name == "flash_inhibitor":   # the prefix sums of v, added per query
        ops += b * n * (kv_heads + heads) * d
    rate = (FP32_INSTR_PER_S if name == "flash_inhibitor"
            else FP32_OPS_PER_S if elem == 4 else BF16_TENSOR_OPS_PER_S)
    return _least(nbytes, ops, rate)


# ---------------------------------------------------------------------------
# Whole steps (the mfu metrics).  ``model`` is a configuration file's dict.
# ---------------------------------------------------------------------------

def matmul_params(model: dict) -> int:
    """Weights a token multiplies through: every projection of every
    layer and the head (the embedding lookup is a gather, not a
    product; a tied head multiplies by the embedding table)."""
    d, ff, v = (model["hidden_size"], model["intermediate_size"],
                model["vocab_size"])
    h, hk = model["num_attention_heads"], model["num_key_value_heads"]
    hd = model["head_dim"]
    per_layer = d * h * hd * 2 + d * hk * hd * 2 + 3 * d * ff
    return model["num_hidden_layers"] * per_layer + d * v


def stored_param_bytes(model: dict) -> int:
    """Bytes of every weight as the program stores it (float32): what a
    step reads once at the least."""
    d, v = model["hidden_size"], model["vocab_size"]
    n = matmul_params(model) + 2 * d * model["num_hidden_layers"] + d
    if not model["tie_word_embeddings"]:
        n += d * v                       # the embedding table beside the head
    return 4 * n


def train_step_least_s(model: dict, b: int, n: int) -> float:
    """Least time of one training step at b x n tokens: the forward and
    backward products (6 FLOPs a weight and token, no recompute) at the
    bf16 peak, plus the inhibitor's operations by ``flash_bound``'s count
    (the forward once, the backward as twice the forward) at the float32
    instruction rate."""
    flops = 6 * matmul_params(model) * b * n
    attn = flash_bound("flash_inhibitor", b, n, 2,
                       model["num_attention_heads"],
                       model["num_key_value_heads"], model["head_dim"])
    return (flops / BF16_TENSOR_OPS_PER_S
            + 3 * model["num_hidden_layers"] * attn["ops"] / FP32_INSTR_PER_S)


def _serve_least_s(model: dict, queries: int, pairs: int,
                   kv_rows: int, kv_elem: int) -> float:
    h, hk, hd = (model["num_attention_heads"], model["num_key_value_heads"],
                 model["head_dim"])
    layers = model["num_hidden_layers"]
    flops = (2 * matmul_params(model) * queries
             + layers * OPS_PER_ELEMENT["flash_inhibitor"] * h * hd * pairs)
    nbytes = (stored_param_bytes(model)
              + layers * 2 * hk * hd * kv_elem * kv_rows)
    return max(flops / BF16_TENSOR_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def decode_least_s(model: dict, keys: Sequence[int],
                   kv_elem: int = 2) -> float:
    """Least time of one decode tick whose rows attend ``keys[row]`` keys
    each (the new one included): the larger of its FLOPs at the bf16 peak
    (2 a weight and row; ``OPS_PER_ELEMENT`` a (query head, attended key,
    d)) and its bytes at the HBM rate (every weight as stored, and each
    attended K / V row, read once)."""
    return _serve_least_s(model, len(keys), sum(keys), sum(keys), kv_elem)


def prefill_least_s(model: dict, start: int, width: int,
                    kv_elem: int = 2) -> float:
    """Least time of one prefill chunk of ``width`` prompt tokens placed at
    ``start``: as :func:`decode_least_s`, a query at ``start + i``
    attending its ``start + i + 1`` keys, K / V of the chunk's last query
    read once."""
    pairs = sum(start + i + 1 for i in range(width))
    return _serve_least_s(model, width, pairs, start + width, kv_elem)
