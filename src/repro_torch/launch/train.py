"""Training launcher.

    python -m repro_torch.launch.train --arch smollm-135m@inhibitor --full \\
        --steps 20 --batch 8 --seq 1024
    python -m repro_torch.launch.train --arch rwkv6-7b --full --layers 4 \\
        --steps 20 --batch 8 --seq 1024

Trains a randomly initialised model (seeded) on the deterministic LM
stream of :mod:`repro_torch.data.pipeline` under restart supervision, on
``--device`` (default ``cuda``; without a card it fails unless ``--device
cpu`` is given).  Without ``--full`` the config is the reduced per-family
one (CPU scale); ``--layers N`` keeps its first N layers.  ``--arch``
names a dense config (``smollm-135m``, ``paper-tiny``) or the RWKV-6
``rwkv6-7b``; at full size the latter's 7.6 B float32 parameters with
AdamW take 122 GB, beyond one 80 GB card, and its first 4 layers 23 GB.
Flags and defaults are the reference launcher's; one
device only: ``--data-parallel`` / ``--model-parallel`` other than 1 and
``--ckpt-dir`` are not ported yet and raise.

Prints one JSON line: the losses, step wall p50, tokens per second and,
on a card, the peak device memory.
"""

from __future__ import annotations

import argparse
import json
import logging
import statistics

import torch


def run(argv=None) -> dict:
    """Parse ``argv``, train, and return the summary (with the history)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--attention", default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="use the reduced per-family config (CPU scale)")
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--layers", type=int, default=None,
                    help="the first N layers (default: all)")
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)

    if args.data_parallel != 1 or args.model_parallel != 1:
        raise NotImplementedError(
            "--data-parallel / --model-parallel other than 1 are not ported "
            "to PyTorch yet (ROADMAP queue 1 item 7: distributed)")
    if args.ckpt_dir is not None:
        raise NotImplementedError(
            "--ckpt-dir is not ported to PyTorch yet (ROADMAP queue 1 item "
            "6: checkpoint/store.py + manager.py and resume)")

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    log = logging.getLogger("repro_torch.launch.train")

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, lm_batch_at
    from repro_torch.device import resolve_device
    from repro_torch.distributed.fault import (SupervisorConfig,
                                               run_supervised)
    from repro_torch.models.registry import get_model
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.train.loop import TrainConfig, train

    device = resolve_device(args.device)
    name = args.arch if not args.attention else f"{args.arch}@{args.attention}"
    cfg = get_config(name)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = cfg.with_layers(args.layers)
    api = get_model(cfg)
    pipe = PipelineConfig(global_batch=args.batch, seq_len=args.seq,
                          vocab_size=cfg.vocab_size, seed=args.seed)
    opt_cfg = AdamWConfig(lr=warmup_cosine(args.lr, 10, args.steps))
    train_cfg = TrainConfig(total_steps=args.steps, seed=args.seed,
                            microbatches=args.microbatches)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    result = {}

    def attempt(i):
        log.info("attempt %d: training %s for %d steps on %s", i, cfg.name,
                 args.steps, device)
        result.update(train(api, opt_cfg, train_cfg,
                            lambda step: lm_batch_at(pipe, step),
                            device=device))

    restarts = run_supervised(attempt,
                              SupervisorConfig(max_restarts=args.max_restarts))
    hist = result["history"]
    walls = [h["seconds"] for h in hist[1:]] or [h["seconds"] for h in hist]
    p50 = statistics.median(walls) if walls else float("nan")
    summary = {
        "arch": name, "full": not args.reduced, "layers": cfg.num_layers,
        "device": str(device),
        "steps": args.steps, "batch": args.batch, "seq": args.seq,
        "microbatches": args.microbatches, "restarts": restarts,
        "losses": [h["loss"] for h in hist],
        "step_wall_s": [h["seconds"] for h in hist],
        "step_wall_ms_p50": p50 * 1e3,
        "tokens_per_s": args.batch * args.seq / p50,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
    }
    if hist:
        log.info("final loss %.4f (first %.4f)", hist[-1]["loss"],
                 hist[0]["loss"])
    return summary


def main(argv=None) -> int:
    print(json.dumps(run(argv)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
