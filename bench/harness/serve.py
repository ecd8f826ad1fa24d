"""A serving cell: the program's engine under a traffic mix of requests.

Set-up draws the weights, builds the engine (``warmup`` "serve" captures
every decode and prefill bucket), and prepares the mix's requests.  An
open loop (``rate`` set) submits each request at its due moment, runs a
ramp of ``ramp_s`` seconds, then the window; an offline queue fills the
batch during set-up and keeps ``queue_depth`` requests waiting through
the window.  Every tick is ``Engine.step`` (inside a ``bench.tick`` range
when traced); tokens are timed on the host as ``Request.on_token`` sees
them.  A traced run traces ``trace_ticks`` more ticks of the same traffic
after the window.  Once the window has closed and the peak memory is
read, the engine is freed, and the reference runs over a sample of the
finished requests, prompt and served tokens, comparing each served
token's logit with the reference's best at its position.
"""

from __future__ import annotations

import gc
import math
import time
import types
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from harness import checks, reference, roofline, traffic, weights
from harness.stats import Timeline
from harness.trace import traced


def engine_config(serve: dict, telemetry: bool):
    from repro_torch.serve.engine import EngineConfig

    return EngineConfig(
        max_batch=serve["max_batch"], max_len=serve["max_len"],
        page_size=serve["page_size"], prefill_chunk=serve["prefill_chunk"],
        tick_budget=serve["tick_budget"], prefix_cache=serve["prefix_cache"],
        warmup=serve["warmup"], greedy=serve["greedy"], allocator="paged",
        telemetry=True if telemetry else None)


class Driver:
    """Submits the mix's requests, runs ticks and records what each tick
    did: the decode rows' attended keys and the prompt tokens each
    admission covered, from the engine's admissions and the tokens
    ``on_token`` saw."""

    def __init__(self, eng, plan: Iterator[traffic.Planned], origin: float,
                 mix: dict):
        from repro_torch.serve.engine import Request

        self.eng, self.mix = eng, mix
        self.timeline = Timeline()
        self.plan = plan
        self.upcoming = next(plan)
        self.origin = origin
        self.requests: Dict[int, object] = {}
        self.prompt_len: Dict[int, int] = {}
        self._emitted: List[tuple] = []
        self._Request = Request
        self.ticks: List[dict] = []
        # the window's peaks: pages in use (the prefix index's included),
        # pages the claimed slots hold, slots that decode
        self.peaks = dict.fromkeys(("pages", "live_pages", "rows"), 0)

    def _on_token(self, req, tok) -> None:
        t = time.perf_counter()
        self.timeline.token(req.request_id, t)
        self._emitted.append((req.request_id, len(req.output) - 1))

    def submit_due(self, now: float) -> None:
        while self.origin + self.upcoming.due <= now:
            self._submit()

    def top_up(self, depth: int) -> None:
        while len(self.eng.scheduler) < depth:
            self._submit()

    def _submit(self) -> None:
        p, self.upcoming = self.upcoming, next(self.plan)
        req = self._Request(p.index, p.prompt, max_new_tokens=p.max_new,
                            on_token=self._on_token)
        self.timeline.add(p.index, self.origin + p.due)
        self.requests[p.index] = req
        self.prompt_len[p.index] = len(p.prompt)
        self.eng.submit(req)

    def next_due(self) -> float:
        return self.origin + self.upcoming.due

    def busy(self) -> bool:
        e = self.eng
        return bool(e.active or e.admitting or len(e.scheduler))

    def tick(self, ranged: bool = False) -> dict:
        e = self.eng
        before = {id(p.req): (p.req.request_id, p.pos)
                  for p in e.admitting.values()}
        counters = dict(e.counters)
        self._emitted = []
        t0 = time.perf_counter()
        if ranged:
            with torch.profiler.record_function("bench.tick"):
                done = e.step()
        else:
            done = e.step()
        t1 = time.perf_counter()
        for key, now in (("pages", e.alloc.pages_in_use),
                         ("live_pages", sum(len(e.alloc.held(slot))
                                            for slot in e.alloc.active())),
                         ("rows", len(e.active))):
            self.peaks[key] = max(self.peaks[key], now)
        for req in done:
            self.timeline.finish(req.request_id, t1)
        after = {id(p.req): (p.req.request_id, p.pos)
                 for p in e.admitting.values()}
        decode_keys = [self.prompt_len[rid] + i for rid, i in self._emitted
                       if i >= 1]
        firsts = {rid for rid, i in self._emitted if i == 0}
        covered = []                     # (start, end) prompt tokens
        for key, (rid, pos) in after.items():
            start = before.get(key, (rid, 0))[1]
            if pos > start:
                covered.append((start, pos))
        for rid in firsts:
            start = next((pos for r, pos in before.values() if r == rid), 0)
            covered.append((start, self.prompt_len[rid]))
        rec = {"t0": t0, "t1": t1, "decode_keys": decode_keys,
               "covered": covered, "decode_tokens": len(decode_keys),
               "decoded": e.counters["decode_ticks"] > counters[
                   "decode_ticks"],
               "prefill_chunks": e.counters["prefill_chunks"]
               - counters["prefill_chunks"]}
        self.ticks.append(rec)
        return rec

    def drive(self, until: Optional[float] = None,
              ticks: Optional[int] = None, ranged: bool = False) -> None:
        """Run the traffic until the host clock passes ``until``, or for
        ``ticks`` ticks."""
        n = 0
        depth = self.mix.get("queue_depth")
        while True:
            now = time.perf_counter()
            if until is not None and now >= until:
                return
            if ticks is not None and n >= ticks:
                return
            if depth is not None:
                self.top_up(depth)
            else:
                self.submit_due(now)
            if self.busy():
                self.tick(ranged)
                n += 1
                continue
            nxt = self.next_due()
            wait = nxt - now if until is None else min(nxt, until) - now
            if wait > 0:
                time.sleep(wait)


def least_s(model: dict, rec: dict, chunk: int) -> float:
    """Least time of a tick's steps: its decode (if it ran) and each
    prefill chunk of ``chunk`` prompt tokens it covered."""
    t = roofline.decode_least_s(model, rec["decode_keys"]) if \
        rec["decode_keys"] else 0.0
    for start, end in rec["covered"]:
        for s in range(start, end, chunk):
            t += roofline.prefill_least_s(model, s, min(chunk, end - s))
    return t


def run(cell, api, seed: int, seconds: float, trace: bool, device,
        t_start: float, *, fault: Optional[str] = None,
        sync: Callable[[], None] = lambda: None) -> dict:
    from repro_torch.serve.engine import Engine

    model, mix, serve = cell.model, cell.mix, cell.model["serve"]
    params = weights.draw(model, seed, device)
    eng = Engine(api, params, engine_config(serve, trace), seed=seed,
                 device=device)
    if fault == "token":
        select = eng._select

        def altered(logits, _select=select):
            out = _select(logits)
            return (out + 1) % model["vocab_size"]

        eng._select = altered
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    rate = mix.get("rate")
    plan = traffic.requests(mix, model["vocab_size"], seed)
    compiles = (eng.prefill_compiles, eng.decode_compiles)

    if rate:
        origin = time.perf_counter()
        drv = Driver(eng, plan, origin, mix)
        drv.drive(until=origin + mix["ramp_s"])
    else:
        drv = Driver(eng, plan, time.perf_counter(), mix)
        fill0 = time.perf_counter()
        while len(eng.active) < serve["max_batch"]:
            drv.top_up(mix["queue_depth"])
            drv.tick()
        fill_s = time.perf_counter() - fill0
    sync()
    w0 = time.perf_counter()
    first_tick = len(drv.ticks)
    counters0 = dict(eng.counters)
    tel0 = eng.tel.now() if eng.tel is not None else None
    drv.peaks = dict.fromkeys(drv.peaks, 0)
    drv.drive(until=w0 + seconds)
    sync()
    w1 = time.perf_counter()
    if rate:
        # a request that fell due while the last tick ran is due in the
        # window too: it enters the TTFT tail with its wait to the close
        drv.submit_due(w1)
    tel1 = eng.tel.now() if eng.tel is not None else None
    pool = {f"window_peak_{k}": v for k, v in drv.peaks.items()}
    pool["pool_pages"] = eng.alloc.num_pages - 1
    window_ticks = drv.ticks[first_tick:]
    counters = {k: eng.counters[k] - counters0.get(k, 0)
                for k in eng.counters}
    finished = [r for rid, r in drv.requests.items()
                if drv.timeline.finished.get(rid, math.inf) <= w1]

    tail, tail_ticks = {}, []
    if trace:
        n = len(drv.ticks)
        with traced("bench.trace", tail):
            drv.drive(ticks=mix["trace_ticks"], ranged=True)
        tail_ticks = drv.ticks[n:]
    in_window = (eng.prefill_compiles, eng.decode_compiles) != compiles
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    spans = _spans(eng.tel, tel0, tel1) if eng.tel is not None else []

    tl = drv.timeline
    e2e = {"setup_s": w0 - t_start,
           "serve_tokens_per_s": tl.tokens_in(w0, w1) / (w1 - w0)}
    due = tl.ttft_ms(w0, w1)
    if rate:
        from harness.stats import percentile

        e2e["ttft_p90_ms"] = percentile(due, 90)
        e2e["itl_p95_ms"] = percentile(tl.itl_ms(w0, w1), 95)
        attempted = [rid for rid, t in tl.due.items() if w0 <= t < w1]
    else:
        attempted = [rid for rid, toks in tl.tokens.items()
                     if any(w0 < t <= w1 for t in toks)]
    failed = sum(drv.requests[rid].truncated for rid in attempted)

    sample = checks.sample_requests(finished, seed, mix["check_tokens"],
                                    mix["check_requests"],
                                    mix.get("check_min_requests", 1))
    seqs = [(np.asarray(r.prompt), list(r.output)) for r in sample]
    # the requests hold the driver (their ``on_token``), the driver the
    # engine: every reference to them goes before the reference runs
    del eng, drv, finished, sample
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    gap = reference_gap(params, model, seqs, device)
    return {
        "attempted": len(attempted), "failed": int(failed), "e2e": e2e,
        "readings": {"logit_gap": gap}, "memory_peak_bytes": peak,
        "reference_s": time.perf_counter() - t_ref,
        "notes": {"fill_s": None if rate else fill_s,
                  "compiled_in_window": in_window,
                  "checked_requests": len(seqs),
                  "checked_tokens": sum(len(o) for _p, o in seqs),
                  "prefix_hit_tokens": counters.get("prefix_hit_tokens"),
                  **pool},
        "r": types.SimpleNamespace(
            kind="serve", model=model, mix=mix, window_s=w1 - w0,
            window_ticks=window_ticks, counters=counters, spans=spans,
            trace=tail.get("trace"), tail_ticks=tail_ticks,
            chunk=serve["prefill_chunk"]),
        "_params": params, "_seqs": seqs,
    }


def _spans(tel, lo: float, hi: float) -> List[tuple]:
    """(name, µs) of the telemetry's begin / end spans of the engine's
    track that begin in [lo, hi)."""
    open_: Dict[str, float] = {}
    out = []
    for ts, ph, name, _cat, tid, _args in tel.events or ():
        if ph == "B":
            open_[name] = ts
        elif ph == "E" and name in open_:
            start = open_.pop(name)
            if lo <= start < hi:
                out.append((name, ts - start))
    return out


@torch.no_grad()
def reference_logits(params, model, prompt, output, device,
                     prec: Optional[str] = None) -> torch.Tensor:
    """The reference's logits at the positions that produced ``output``:
    the prompt's last and each served token's but the last."""
    seq = np.concatenate([prompt, np.asarray(output[:-1], np.int32)])
    toks = torch.from_numpy(seq.astype(np.int64))[None].to(device)
    with reference.exact_float32():
        lg = reference.logits(params, model, toks, prec)[0]
    return lg[len(prompt) - 1:]


def reference_gap(params, model, seqs, device) -> float:
    """The widest gap over the sampled requests; with none finished there
    is nothing that could be right, and the gap is infinite."""
    gap = 0.0 if seqs else float("inf")
    for prompt, output in seqs:
        lg = reference_logits(params, model, prompt, output, device)
        gap = max(gap, checks.served_gap(lg, torch.tensor(output,
                                                          device=device)))
    return gap
