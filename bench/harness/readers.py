"""What the per-layer metrics read, shared by the readers under
``bench/metrics/``.  ``r`` is a driver's record: ``r.kind``, ``r.model``,
``r.mix``, ``r.window_s``, ``r.trace`` (the traced slice after the
window, or None; over several chips rank 0's) and, for training,
``r.window_steps``, ``r.chips`` and ``r.mesh`` (data, model); for serving,
``r.window_ticks`` / ``r.tail_ticks`` (what each tick did),
``r.counters`` (the engine's counters over the window), ``r.spans`` (its
telemetry spans in the window).  A reader returns None where it finds
nothing to read, never 0 for a share.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from harness import roofline

BACKWARD_RANGE = "repro_torch.flash_backward"
FLASH_KERNEL = "flash_inhibitor_kernel"
PAGED_KERNELS = ("paged_inhibitor_split_kernel",
                 "paged_inhibitor_merge_kernel")


def _complete_ranges(r, name: str) -> List[Tuple[float, float]]:
    if r.trace is None:
        return []
    return [(lo, hi) for lo, hi in r.trace.ranges(name)
            if r.trace.complete(lo, hi)]


def train_mfu_pct(r) -> Optional[float]:
    """The window's least time over its wall time on ``r.chips`` chips
    (the steps' global batch over all of their peaks)."""
    if r.kind != "train" or not r.window_steps:
        return None
    least = r.window_steps * roofline.train_step_least_s(
        r.model, r.mix["batch"], r.mix["seq_len"])
    return 100.0 * least / (r.window_s * r.chips)


def backward_ms_per_step(r) -> Optional[float]:
    steps = _complete_ranges(r, "bench.train_step")
    if not steps:
        return None
    total = 0.0
    for lo, hi in steps:
        for blo, bhi in r.trace.ranges(BACKWARD_RANGE):
            if lo <= blo and bhi <= hi:
                total += sum(float(e["dur"])
                             for e in r.trace.records_in(blo, bhi))
    return total / len(steps) * 1e-3


def flash_roofline_pct(r) -> Optional[float]:
    steps = _complete_ranges(r, "bench.train_step")
    us, n = 0.0, 0
    for lo, hi in steps:
        d, k = r.trace.named_us(r.trace.records_in(lo, hi), FLASH_KERNEL)
        us, n = us + d, n + k
    if not n:
        return None
    m = r.model
    b = roofline.flash_bound("flash_inhibitor", r.mix["batch"],
                             r.mix["seq_len"], 2, m["num_attention_heads"],
                             m["num_key_value_heads"], m["head_dim"])
    return 100.0 * b["bound_ms"] * 1e3 / (us / n)


def idle_pct(r, range_name: Optional[str] = None) -> Optional[float]:
    """Share of the traced slice (or of its ranges named ``range_name``)
    with no device record running."""
    if r.trace is None:
        return None
    if range_name is None:
        spans = [(r.trace.lo, r.trace.hi)]
    else:
        spans = _complete_ranges(r, range_name)
    if not spans:
        return None
    length = sum(hi - lo for lo, hi in spans)
    busy = sum(r.trace.busy_us(None, lo, hi) for lo, hi in spans)
    return 100.0 * (1.0 - busy / length)


def _decode_ticks(r):
    """(tick record, device records of its decode step) of each complete
    traced tick that decoded: the decode step is the tick's last graph
    launch (its prefill chunks' launches come before it).  The ticks and
    their ``bench.tick`` ranges are in the same order."""
    if r.trace is None:
        return []
    out = []
    for t, (lo, hi) in zip(r.tail_ticks, r.trace.ranges("bench.tick")):
        if not t["decoded"] or not r.trace.complete(lo, hi):
            continue
        launches = [c for c in r.trace.calls_in(lo, hi)
                    if "GraphLaunch" in c.get("name", "")]
        if launches:
            last = max(launches, key=lambda c: float(c["ts"]))
            out.append((t, r.trace.records_of([last])))
    return out


def decode_device_ms(r) -> Optional[float]:
    ticks = _decode_ticks(r)
    if not ticks:
        return None
    return sum(float(e["dur"]) for _t, recs in ticks
               for e in recs) / len(ticks) * 1e-3


def paged_roofline_pct(r) -> Optional[float]:
    """The paged kernels' least time, from each decoding row's attended
    keys (the traffic shares no prefix, so each row's pages are its own),
    summed over the layers of every traced decode step, over their
    device time."""
    m = r.model
    bound_ms, us = 0.0, 0.0
    for t, recs in _decode_ticks(r):
        keys = t["decode_keys"]
        if not keys:
            continue
        tables = [[row * 10 ** 6 + p for p in range(-(-k // roofline.PAGE))]
                  for row, k in enumerate(keys)]
        b = roofline.bound("paged_inhibitor", tables, keys,
                           heads=m["num_attention_heads"],
                           kv_heads=m["num_key_value_heads"],
                           d=m["head_dim"], elem=2)
        bound_ms += b["bound_ms"] * m["num_hidden_layers"]
        us += r.trace.named_us(recs, *PAGED_KERNELS)[0]
    if not us:
        return None
    return 100.0 * bound_ms * 1e3 / us


def serve_mfu_pct(r) -> Optional[float]:
    from harness.serve import least_s

    if r.kind != "serve" or not r.window_ticks:
        return None
    least = sum(least_s(r.model, t, r.chunk) for t in r.window_ticks)
    return 100.0 * least / r.window_s


def prefill_ms_per_token(r) -> Optional[float]:
    spans = [us for name, us in r.spans if name == "prefill_pass"]
    tokens = r.counters.get("prefill_tokens", 0)
    if not spans or not tokens:
        return None
    return sum(spans) * 1e-3 / tokens


def decode_rows_per_tick(r) -> Optional[float]:
    ticks = [t for t in r.window_ticks if t["decoded"]]
    if not ticks:
        return None
    return sum(t["decode_tokens"] for t in ticks) / len(ticks)
