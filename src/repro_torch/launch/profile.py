"""Profile one full-width paged decode step, or one train step, on the
card.

    python -m repro_torch.launch.profile --arch smollm-135m@inhibitor \\
        --out profile_inhibitor.json
    python -m repro_torch.launch.profile --train --arch smollm-135m@inhibitor
    python -m repro_torch.launch.profile --train --arch rwkv6-7b --layers 4

``--train`` profiles ``make_train_step`` at full width (batch 8 x seq
1024 of the seeded LM stream by default) and full depth, or the first
``--layers`` layers (rwkv6-7b's 32 do not fit AdamW on one 80 GB card):
step wall (host clock to a synchronize), device busy time and idle share
from the same ``torch.profiler`` CUDA trace, and the device time split
between the flash forward kernels and the WKV kernel (their launches,
remat recompute included), the attention backward recompute through the
reference (the ``kernels.ops.BACKWARD_RANGE`` profiler range), the WKV
backward (``kernels.ops.WKV6_BACKWARD_RANGE``) and the rest, with the
top kernels.

Without ``--train``:

Builds the model from a seeded generator, a paged decode state whose rows
hold ragged contexts of random K/V (the serve phase's batch of 8), and
times ``lm_step`` — the engine's decode tick without the host
bookkeeping — three ways:

  * wall: host clock around each step, ending in a synchronize;
  * device: ``torch.profiler`` CUDA activity over the same steps — total
    kernel time, launches per step and the top kernels by time, so the
    device's idle share (1 - device / wall) shows how far the host holds
    the card back;
  * the paged decode kernel alone: its device time per wrapper call from
    the same trace (the split Softmax's two kernels together), beside
    the wrapper's per-call time by CUDA events.

Prints one JSON object (and writes it to ``--out`` when given).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    raise AttributeError("profiler event has no device time field")


def build_state(cfg, lengths, *, page_size: int, max_len: int, gen,
                device):
    """Paged state with random K/V behind ragged cursors ``lengths``."""
    from repro_torch.models import transformer as tfm

    st = tfm.init_states(cfg, len(lengths), max_len, per_slot=True,
                         paged=True, page_size=page_size, device=device)
    kv = st.kv
    kv.k.copy_(torch.randn(kv.k.shape, generator=gen, device=device))
    kv.v.copy_(torch.randn(kv.v.shape, generator=gen, device=device))
    perm = (torch.randperm(kv.k.shape[1] - 1, generator=gen,
                           device=device) + 1).tolist()
    tables = torch.zeros(kv.block_tables.shape, dtype=torch.int32)
    nxt = 0
    for row, ln in enumerate(lengths):
        used = -(-(ln + 1) // page_size)
        tables[row, :used] = torch.tensor(perm[nxt:nxt + used])
        nxt += used
    kv.block_tables.copy_(tables)
    kv.length.copy_(torch.tensor(lengths, dtype=torch.int32))
    return st


def _kernel_events(prof, ranges=()):
    """Device-side kernel events only: CPU ops also carry the device time
    of the kernels they launched, and summing both counts it twice; the
    device-side copies of profiler ``ranges`` span kernels and are left
    out for the same reason."""
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in ranges]
    if not kernels:
        raise SystemExit("profile: the trace holds no CUDA kernel events")
    return events, kernels


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def profile_train(args, device) -> dict:
    """One full-width train step: wall vs device time, and where the
    device time goes."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, lm_batch_at
    from repro_torch.kernels import ops as kops
    from repro_torch.models.registry import get_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = get_config(args.arch)
    if args.layers:
        cfg = cfg.with_layers(args.layers)
    api = get_model(cfg)
    opt_cfg = AdamWConfig(lr=3e-4)
    params, opt_state = init_train_state(
        api, opt_cfg, torch.Generator(device=device).manual_seed(0),
        device=device)
    step_fn = make_train_step(api, opt_cfg)
    pipe = PipelineConfig(global_batch=args.batch, seq_len=args.seq,
                          vocab_size=cfg.vocab_size)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in lm_batch_at(pipe, 0).items()}

    def step():
        nonlocal params, opt_state
        params, opt_state, m = step_fn(params, opt_state, batch)
        return m["loss"]

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    wall = []
    for _ in range(args.steps or 3):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)

    kops.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in kops.counts().items() if v}
    range_names = (kops.BACKWARD_RANGE, kops.WKV6_BACKWARD_RANGE)
    events, kernels = _kernel_events(prof, range_names)
    device_ms = sum(_device_us(e) for e in kernels) / 1e3

    def kernel_ms(*names):
        return sum(_device_us(e) for e in kernels
                   if any(n in e.key for n in names)) / 1e3

    fwd_ms = kernel_ms("flash_inhibitor_kernel", "flash_attention_kernel",
                       "flash_attention_tc_kernel")
    wkv_ms = kernel_ms("wkv6_tc_kernel")

    # a range's CPU events: their device time sums the kernels of the ops
    # under them (the trace also holds a device-side copy of each range)
    def range_events(name):
        return [e for e in prof.events() if e.name == name
                and e.device_type == torch.autograd.DeviceType.CPU]

    ranges = range_events(kops.BACKWARD_RANGE)
    wkv_ranges = range_events(kops.WKV6_BACKWARD_RANGE)
    bwd_ms = sum(e.device_time_total for e in ranges) / 1e3
    wkv_bwd_ms = sum(e.device_time_total for e in wkv_ranges) / 1e3
    top = sorted(kernels, key=_device_us, reverse=True)[:15]
    p50 = statistics.median(wall)
    return {
        "mode": "train", "arch": args.arch, "layers": cfg.num_layers,
        "card": _card(), "batch": args.batch, "seq": args.seq,
        "torch": torch.__version__,
        "step_wall_ms_p50": p50, "step_wall_ms": wall,
        "profiled_step_wall_ms": prof_wall_ms,
        "step_device_ms": device_ms,
        "device_idle_share": 1.0 - device_ms / p50,
        "device_kernels_per_step": sum(e.count for e in kernels),
        "tokens_per_s": args.batch * args.seq / (p50 / 1e3),
        "launches": launches,
        "backward_ranges": len(ranges),
        "wkv6_backward_ranges": len(wkv_ranges),
        "device_ms_split": {"flash_forward_kernel": fwd_ms,
                            "backward_recompute": bwd_ms,
                            "wkv6_forward_kernel": wkv_ms,
                            "wkv6_backward": wkv_bwd_ms,
                            "rest": (device_ms - fwd_ms - bwd_ms - wkv_ms
                                     - wkv_bwd_ms)},
        "peak_memory_bytes": torch.cuda.max_memory_allocated(device),
        "top_kernels": [{"name": e.key[:80], "count": e.count,
                         "device_ms": _device_us(e) / 1e3} for e in top],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m@inhibitor")
    ap.add_argument("--lengths", default="127,127,127,127,127,127,127,127",
                    help="per-row context before the step (comma list)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--steps", type=int, default=None,
                    help="timed steps (default: 20 decode, 3 train)")
    ap.add_argument("--train", action="store_true",
                    help="profile one train step instead of a decode step")
    ap.add_argument("--batch", type=int, default=8, help="train batch")
    ap.add_argument("--seq", type=int, default=1024, help="train seq len")
    ap.add_argument("--layers", type=int, default=None,
                    help="train: the first N layers (default: all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import paged as kpaged
    from repro_torch.models import transformer as tfm

    device = resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("profile: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.train:
        return _report(profile_train(args, device), args.out)
    cfg = get_config(args.arch)
    lengths = [int(x) for x in args.lengths.split(",")]
    gen = torch.Generator(device=device).manual_seed(0)
    params = tfm.init_lm(torch.Generator().manual_seed(0), cfg,
                         device=device)
    st = build_state(cfg, lengths, page_size=args.page_size,
                     max_len=args.max_len, gen=gen, device=device)
    tokens = torch.randint(0, cfg.vocab_size, (len(lengths), 1),
                           generator=gen, device=device)

    def step():
        # same shapes every step: the cursor is not advanced
        return tfm.lm_step(params, cfg, tokens, st)[0]

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    wall = []
    for _ in range(args.steps or 20):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)

    from torch.profiler import ProfilerActivity, profile

    n_prof = 5
    kpaged.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            step()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / n_prof
    launches = kpaged.counts()
    events, kernels = _kernel_events(prof)
    device_ms = sum(_device_us(e) for e in kernels) / 1e3 / n_prof
    n_launch = sum(e.count for e in kernels) / n_prof
    runtime_launches = sum(e.count for e in events
                           if "LaunchKernel" in e.key) / n_prof
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    paged = [e for e in kernels if "paged_" in e.key]
    # per wrapper call: the split Softmax launches a merge kernel too
    paged_us = (sum(_device_us(e) for e in paged)
                / max(1, launches["paged_inhibitor"]
                      + launches["paged_attention"]))

    # the wrapper alone, by CUDA events (includes its host-side checks)
    q = torch.randn((len(lengths), 1, cfg.attention.num_heads,
                     cfg.attention.head_dim), generator=gen,
                    device=device).to(cfg.cdtype)
    kv = st.kv
    lens = (kv.length + 1).contiguous()
    fwd = (kpaged.paged_flash_inhibitor_fwd
           if cfg.attention.mechanism.startswith("inhibitor")
           else kpaged.paged_flash_attention_fwd)
    for _ in range(3):
        fwd(q, kv.k[0], kv.v[0], kv.block_tables, lens)
    torch.cuda.synchronize()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    n_calls = 200
    ev0.record()
    for i in range(n_calls):
        fwd(q, kv.k[i % cfg.num_layers], kv.v[i % cfg.num_layers],
            kv.block_tables, lens)
    ev1.record()
    ev1.synchronize()
    call_ms = ev0.elapsed_time(ev1) / n_calls

    out = {
        "arch": args.arch, "card": _card(), "batch": len(lengths),
        "lengths": lengths, "torch": torch.__version__,
        "step_wall_ms_p50": statistics.median(wall),
        "step_wall_ms_min": min(wall),
        "profiled_step_wall_ms": prof_wall_ms,
        "step_device_ms": device_ms,
        "device_idle_share": 1.0 - device_ms / statistics.median(wall),
        "device_kernels_per_step": n_launch,
        "runtime_launch_calls_per_step": runtime_launches,
        "paged_kernel_launches_per_step": {
            k: v / n_prof for k, v in launches.items() if v},
        "paged_kernel_device_us": paged_us,
        "paged_wrapper_call_ms": call_ms,
        "top_kernels": [{"name": e.key[:80], "count": e.count // n_prof,
                         "device_us_per_step": _device_us(e) / n_prof}
                        for e in top],
    }
    return _report(out, args.out)


def _report(out: dict, path) -> int:
    text = json.dumps(out, indent=1)
    print(text, flush=True)
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
