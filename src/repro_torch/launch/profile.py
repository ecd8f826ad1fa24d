"""Profile one full-width paged decode step on the card.

    python -m repro_torch.launch.profile --arch smollm-135m@inhibitor \\
        --out profile_inhibitor.json

Builds the model from a seeded generator, a paged decode state whose rows
hold ragged contexts of random K/V (the serve phase's batch of 8), and
times ``lm_step`` — the engine's decode tick without the host
bookkeeping — three ways:

  * wall: host clock around each step, ending in a synchronize;
  * device: ``torch.profiler`` CUDA activity over the same steps — total
    kernel time, launches per step and the top kernels by time, so the
    device's idle share (1 - device / wall) shows how far the host holds
    the card back;
  * the paged decode kernel alone: its device time per launch from the
    same trace, beside the wrapper's per-call time by CUDA events.

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m@inhibitor")
    ap.add_argument("--lengths", default="127,127,127,127,127,127,127,127",
                    help="per-row context before the step (comma list)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--steps", type=int, default=20)
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
    for _ in range(args.steps):
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
    events = prof.key_averages()
    # device-side kernel events only: CPU ops also carry the device time
    # of the kernels they launched, and summing both counts it twice
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise SystemExit("profile: the trace holds no CUDA kernel events")
    device_ms = sum(_device_us(e) for e in kernels) / 1e3 / n_prof
    n_launch = sum(e.count for e in kernels) / n_prof
    runtime_launches = sum(e.count for e in events
                           if "LaunchKernel" in e.key) / n_prof
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    paged = [e for e in kernels if "paged_" in e.key]
    paged_us = (sum(_device_us(e) for e in paged)
                / max(1, sum(e.count for e in paged)))

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

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {
        "arch": args.arch, "card": smi, "batch": len(lengths),
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
    text = json.dumps(out, indent=1)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
