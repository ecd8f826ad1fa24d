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
names any config of :mod:`repro_torch.configs` (dense, MoE, hybrid, the
RWKV-6 ``rwkv6-7b``, and the vlm ``llava-next-mistral-7b`` text-only,
as the reference's launcher trains it: the LM stream has no image
embeddings); the encoder-decoder is refused with a ``ValueError``, since
the token stream has no frames for its encoder.  At full size
``rwkv6-7b``'s 7.6 B float32
parameters with AdamW take 122 GB, beyond one 80 GB card, and its first
4 layers 23 GB (``qwen2-moe-a2.7b``'s 15 B, 242 GB).
Flags and defaults are the reference launcher's.  A ("data", "model")
mesh of ``--data-parallel`` x ``--model-parallel`` > 1 trains on that
many ranks under ``torchrun``::

    python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --device cpu \
        --data-parallel 2 --model-parallel 2 --steps 6

one process per rank (gloo for ``--device cpu``, NCCL on ``cuda:
{LOCAL_RANK}`` otherwise), the state sharded by the rules the dry-run
places (:mod:`repro_torch.launch.shardings`), each step the sharded one;
rank 0 prints the summary.  A mesh larger than the world exits with
``mesh DxM needs N devices, have W``.  ``--ckpt-dir DIR`` commits a checkpoint every
``--ckpt-every`` steps and at the end, and a rerun resumes from the newest
commit under DIR (fault tolerance: auto-resume + restart supervision);
under a mesh rank 0 writes the gathered state and every rank resumes
from the step rank 0 finds, into its own shards.

Prints one JSON line: the step it started from, the losses, step wall
p50, tokens per second and, on a card, the peak device memory.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
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
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)

    dp, mp = args.data_parallel, args.model_parallel
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dp * mp > world:
        raise SystemExit(f"mesh {dp}x{mp} needs {dp * mp} devices, "
                         f"have {world}")
    if 1 < dp * mp < world:
        raise SystemExit(f"mesh {dp}x{mp} uses {dp * mp} of the {world} "
                         "ranks; run as many ranks as the mesh holds")

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    log = logging.getLogger("repro_torch.launch.train")

    from repro_torch.checkpoint import CheckpointConfig
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, lm_batch_at
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.device import resolve_device
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.distributed.fault import (SupervisorConfig,
                                               run_supervised)
    from repro_torch.models.registry import get_model
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.train.loop import TrainConfig, train

    distributed = dp * mp > 1
    if distributed:
        import torch.distributed as dist

        if args.device == "cpu":
            dist.init_process_group("gloo")
            device = resolve_device("cpu")
        else:
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(device)
            dist.init_process_group("nccl", device_id=device)
    else:
        device = resolve_device(args.device)
    name = args.arch if not args.attention else f"{args.arch}@{args.attention}"
    cfg = get_config(name)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = cfg.with_layers(args.layers)
    if cfg.family == "encdec":
        raise ValueError(
            f"{name}: the encoder-decoder trains on (frames, tokens) "
            f"batches, and the token pipeline (data.pipeline.lm_batch_at) "
            f"has no frames")
    api = get_model(cfg)
    pipe = PipelineConfig(global_batch=args.batch, seq_len=args.seq,
                          vocab_size=cfg.vocab_size, seed=args.seed)
    opt_cfg = AdamWConfig(lr=warmup_cosine(args.lr, 10, args.steps))
    train_cfg = TrainConfig(
        total_steps=args.steps, seed=args.seed,
        microbatches=args.microbatches,
        checkpoint=(CheckpointConfig(args.ckpt_dir,
                                     every_steps=args.ckpt_every)
                    if args.ckpt_dir else None))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    result = {}

    def attempt(i):
        log.info("attempt %d: training %s for %d steps on %s, %dx%d mesh",
                 i, cfg.name, args.steps, device, dp, mp)
        with contextlib.ExitStack() as stack:
            if distributed:
                stack.enter_context(use_mesh(make_mesh(dp, mp)))
            result.update(train(api, opt_cfg, train_cfg,
                                lambda step: lm_batch_at(pipe, step),
                                device=device))

    try:
        restarts = run_supervised(
            attempt, SupervisorConfig(max_restarts=args.max_restarts))
    finally:
        if distributed:
            dist.destroy_process_group()
    hist = result["history"]
    walls = [h["seconds"] for h in hist[1:]] or [h["seconds"] for h in hist]
    p50 = statistics.median(walls) if walls else float("nan")
    summary = {
        "arch": name, "full": not args.reduced, "layers": cfg.num_layers,
        "device": str(device), "mesh": [dp, mp],
        "steps": args.steps, "batch": args.batch, "seq": args.seq,
        "microbatches": args.microbatches, "restarts": restarts,
        "start_step": hist[0]["step"] if hist else args.steps,
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
    summary = run(argv)
    if int(os.environ.get("RANK", "0")) == 0:
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
