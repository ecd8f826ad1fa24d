"""Serving launcher: the continuous-batching engine over a randomly
initialised model.

    python -m repro_torch.launch.serve --arch smollm-135m@inhibitor --full

Builds the model from a seeded ``torch.Generator`` on ``--device``
(default ``cuda``; without a card it fails unless ``--device cpu`` is
given), drives the engine with synthetic ragged prompt traffic and reports
throughput, the paged-cache accounting and the prefix-cache counters.
``--allocator contiguous`` selects the dense per-slot baseline;
``--shared-prefix N`` gives every prompt a common N-token prefix;
``--tick-budget N`` interleaves chunked prefill with decode ticks.
``--metrics-json PATH`` writes the engine's counters and histograms.
"""

from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--attention", default=None)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
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
    ap.add_argument("--metrics-json", default=None,
                    help="write the engine metrics registry (counters + "
                         "bounded histograms) plus stats() here")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger("repro_torch.launch.serve")

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import Engine, EngineConfig, Request

    device = resolve_device(args.device)
    name = args.arch if not args.attention else f"{args.arch}@{args.attention}"
    cfg = get_config(name)
    if args.reduced:
        cfg = cfg.reduced()
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(args.seed), device=device)
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
                              temperature=args.temperature),
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
    done = eng.run_to_completion()
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.output) for r in done)
    log.info("served %d requests, %d tokens in %.2fs (%.1f tok/s) on %s",
             len(done), total_tokens, dt, total_tokens / dt, device)
    log.info("step shapes: prefill %d (buckets: %s), decode %d",
             eng.prefill_compiles, sorted(eng._prefill_buckets),
             eng.decode_compiles)
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
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump({"stats": stats, "metrics": eng.metrics.snapshot()},
                      f, indent=2, sort_keys=True)
        log.info("metrics: wrote %s", args.metrics_json)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
