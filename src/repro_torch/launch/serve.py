"""Serving launcher: the continuous-batching engine over a randomly
initialised model.

    python -m repro_torch.launch.serve --arch smollm-135m@inhibitor --full

``--arch`` names any config of :mod:`repro_torch.configs`: the dense,
MoE, hybrid and vlm families serve through the paged pool (the hybrid
one without a prefix cache; the vlm text-only, as in the reference),
RWKV-6 through contiguous slots; the encoder-decoder is refused by the
engine (``ValueError``: its step needs the encoder's memory, which no
request carries).
Builds the model from a seeded ``torch.Generator`` on ``--device``
(default ``cuda``; without a card it fails unless ``--device cpu`` is
given), or loads its parameters from the newest commit under
``--ckpt-dir`` (a ``launch.train --ckpt-dir`` run's), drives the engine
with synthetic ragged prompt traffic and reports throughput, the
paged-cache accounting and the prefix-cache counters.
``--allocator contiguous`` selects the dense per-slot baseline;
``--shared-prefix N`` gives every prompt a common N-token prefix;
``--tick-budget N`` interleaves chunked prefill with decode ticks.
``--metrics-json PATH`` writes the engine's counters and histograms.

Observability: ``--trace-out trace.json`` records the span timeline
(request lifecycles, tick phases, kernel/plan provenance) as Chrome
trace-event JSON — load it at ui.perfetto.dev, or validate and summarize
it with ``python -m repro_torch.serve.telemetry trace.json``.
``--log-json`` prints one JSON line of tick counters per engine tick and
arms the flight recorder, whose dump path is printed when the engine
aborts (no progress, the compile-budget check).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--attention", default=None)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the parameters of the newest commit here")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--allocator", choices=("paged", "contiguous"),
                    default="paged")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="paged pool size (default: full capacity)")
    ap.add_argument("--prefill-chunk", "--chunk-tokens", type=int,
                    default=32, dest="prefill_chunk",
                    help="prefill chunk width in tokens (--chunk-tokens is "
                         "an alias)")
    ap.add_argument("--tick-budget", type=int, default=None,
                    help="max (padded) prefill tokens executed per engine "
                         "tick; default: whole-prompt admission")
    ap.add_argument("--scheduler", choices=("fifo", "priority", "prefix"),
                    default="fifo", help="admission policy")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false", default=True,
                    help="disable the shared-prefix radix KV cache")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="tokens of common prompt prefix across requests")
    ap.add_argument("--sample", action="store_true",
                    help="temperature sampling instead of greedy decode")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace-event JSON timeline here "
                         "(validate with python -m "
                         "repro_torch.serve.telemetry PATH)")
    ap.add_argument("--metrics-json", default=None,
                    help="write the engine metrics registry (counters + "
                         "bounded histograms) plus stats() here")
    ap.add_argument("--log-json", action="store_true",
                    help="one JSON line of tick counters per engine tick on "
                         "stdout; also arms the crash flight recorder")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger("repro_torch.launch.serve")

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import Engine, EngineConfig, Request
    from repro_torch.serve.telemetry import TelemetryConfig, write_trace

    # telemetry is opt-in: the full span trace when a trace sink is given,
    # the flight-recorder ring alone under --log-json, else none (the
    # engine's hooks are is-None guarded: off means no events at all)
    telemetry = None
    if args.trace_out:
        telemetry = TelemetryConfig(trace=True)
    elif args.log_json:
        telemetry = TelemetryConfig(trace=False)

    device = resolve_device(args.device)
    name = args.arch if not args.attention else f"{args.arch}@{args.attention}"
    cfg = get_config(name)
    if args.reduced:
        cfg = cfg.reduced()
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(args.seed), device=device)
    if args.ckpt_dir:
        from repro_torch.checkpoint import restore

        (params, _), step = restore(args.ckpt_dir, (params, None),
                                    device=device)
        log.info("params: step %d of %s", step, args.ckpt_dir)
    eng = Engine(api, params,
                 EngineConfig(max_batch=args.max_batch,
                              max_len=args.max_len,
                              allocator=args.allocator,
                              page_size=args.page_size,
                              num_pages=args.num_pages,
                              prefill_chunk=args.prefill_chunk,
                              tick_budget=args.tick_budget,
                              prefix_cache=args.prefix_cache,
                              scheduler=args.scheduler,
                              greedy=not args.sample,
                              temperature=args.temperature,
                              telemetry=telemetry),
                 seed=args.seed, device=device)

    rng = np.random.default_rng(args.seed)
    plen = max(1, min(args.prompt_len, args.max_len - 1))
    shared_len = max(0, min(args.shared_prefix, plen - 1))
    shared = rng.integers(0, cfg.vocab_size, (shared_len,)).astype(np.int32)
    t0 = time.perf_counter()
    for i in range(args.requests):
        tail = rng.integers(0, cfg.vocab_size,
                            (plen - shared_len,)).astype(np.int32)
        eng.submit(Request(i, np.concatenate([shared, tail]),
                           max_new_tokens=args.new_tokens))
    on_tick = None
    if args.log_json:
        def on_tick(e, finished):
            # one line per tick, stable keys: counter reads only
            print(json.dumps({
                "tick": e._tick, "active": len(e.active),
                "admitting": len(e.admitting),
                "queued": len(e.scheduler), "finished": len(finished),
                "finished_total": e.counters["finished_requests"],
                "generated_tokens": e.counters["generated_tokens"],
                "prefill_tokens": e.counters["prefill_tokens"],
                "table_uploads": e.counters["table_uploads"],
                "paused_prefills": e.counters["paused_prefills"],
            }, sort_keys=True), flush=True)
    try:
        done = eng.run_to_completion(on_tick=on_tick)
    except RuntimeError as err:
        # _dump_on_error wrote the flight recorder and put its path in
        # the message; restate it for log scrapers
        log.error("engine aborted: %s", err)
        if "[flight recorder:" in str(err):
            path = str(err).rsplit("[flight recorder: ", 1)[1].rstrip("]")
            print(f"FLIGHT RECORDER: {path}", file=sys.stderr)
        return 1
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.output) for r in done)
    log.info("served %d requests, %d tokens in %.2fs (%.1f tok/s) on %s",
             len(done), total_tokens, dt, total_tokens / dt, device)
    budget = eng.retrace_budget()
    log.info("static steps: prefill %d/%d proven (buckets: %s), decode "
             "%d/%d; graphs %s", eng.prefill_compiles,
             budget["prefill_proven"], sorted(eng._prefill_steps),
             eng.decode_compiles, budget["decode_proven"],
             eng.graph_stats())
    if eng.paged:
        log.info("page pool: high-water %d / %d pages (page_size=%d)",
                 eng.alloc.high_water_pages, eng.alloc.num_pages - 1,
                 eng.alloc.page_size)
    stats = eng.stats()
    log.info("scheduler=%s prefill_tokens=%d prefix_hit_tokens=%d "
             "(%d request hits) forked_pages=%d evictions=%d "
             "cached_pages=%d", stats["scheduler"], stats["prefill_tokens"],
             stats["prefix_hit_tokens"], stats["prefix_hit_requests"],
             stats["forked_pages"], stats["evictions"],
             stats["cached_pages"])
    log.info("latency: ttft p50=%.1fms p99=%.1fms | itl p50=%.2fms "
             "p99=%.2fms | queued_ticks p99=%.0f | paused_prefills=%d",
             stats["ttft_ms_p50"], stats["ttft_ms_p99"],
             stats["itl_ms_p50"], stats["itl_ms_p99"],
             stats["queued_ticks_p99"], stats["paused_prefills"])
    for r in done[:3]:
        log.info("req %d -> %s...", r.request_id, r.output[:8])
    if args.trace_out:
        write_trace(eng.tel, args.trace_out)
        log.info("trace: wrote %s (%d events); validate with `python -m "
                 "repro_torch.serve.telemetry %s`", args.trace_out,
                 len(eng.tel.events), args.trace_out)
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump({"stats": stats, "metrics": eng.metrics.snapshot()},
                      f, indent=2, sort_keys=True)
        log.info("metrics: wrote %s", args.metrics_json)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
