#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

  1. device  — require CUDA; print the card's name and power limit.
  2. build   — compile the CUDA kernels (csrc/paged_decode.cu,
               csrc/flash_prefill.cu, csrc/wkv6.cu) from the checkout, one
               nvcc per source, started together.
  3. parity  — each paged decode kernel against its plain PyTorch version
               on the card, at smollm-135m's decode shapes (h=9, h_kv=3,
               d=64, page 16, batch 8, table width 32, ragged lengths 1..512,
               two rows sharing pages, a poisoned trash page, a window
               case), both split kernels also at 5 and 8 query heads per
               kv head, with kernel, plain, library and bound times, the
               kernel's and the library's device time per call (CUDA
               kernels in a torch.profiler trace, no host time) and each
               split kernel's launch grid (splits and blocks) read from
               that trace.
  4. serve   — smollm-135m@inhibitor, then smollm-135m (dot-product), at
               full width (bf16 compute, seeded random init) through the
               paged engine: 8 requests, 128-token prompts, 32 new tokens.
               Each arm's launch counts are zeroed just before it is
               driven and read just after: its kernel must launch decode
               ticks x 30 times and its plain version never.
  5. decode_paths — one full-width paged decode step through the kernel
               and through the forced gather backend; logits must agree.
  6. flash_parity — each blockwise flash kernel (training forward)
               against its plain version on the card at smollm-135m's
               heads (9 / 3, d 64), float32 and bf16: b 1 x n 1024 causal
               (signed, unsigned), b 2 x n 1000 with window 64, ragged
               per-row cursors with nan past every cursor, and the train
               phase's shapes (b 8 x n 1024 causal, bf16); the inhibitor
               also unnormalized, without a mask, with a window edge
               inside a key tile, at head_dim 32 and 128, and with cursors
               unsigned and unnormalized and at head_dim 32 and 128; then
               kernel, plain, library and bound times and device times per
               call at the train shapes.
  7. train   — smollm-135m@inhibitor, then smollm-135m, at full width and
               depth (float32 parameters, bf16 compute, remat "full"),
               through ``repro_torch.train.loop.train`` (the loop the
               training launcher runs) with the launcher's optimizer,
               fitting one batch 8 x seq 1024 of the seeded LM stream.
               The planner must pick ``pallas`` on its own; the arm's
               flash kernel must launch steps x 30 x 2 times (forward and
               remat recompute), its plain version never; every loss
               finite and the last below the first by TRAIN_MIN_FALL.
  8. train_xcheck — one full-width train step at depth 2, b 1 x n 1024,
               through the kernel path and the plain path (backend forced
               to chunked / fused): loss and every gradient must agree
               within XCHECK_TOL, and the plain path with V negated must
               not.
  9. wkv_parity — the RWKV-6 WKV kernel against its plain version on the
               card: the reference's sweep, t below one chunk, t = 1 and
               t = 0, tails ending inside a 16-row tile, chunks of
               8, 16, 20, 32 and 64, head_dim 8 to 64, decays mixed /
               zero / near one, float32 and bf16 r/k/v; the train shape
               (b 8 x t 1024, 64 heads of 64, bf16) and the full-depth
               forward's (b 2 x t 1024) held the same way; then at both
               shapes the kernel's ms and device µs per call and launch
               grid, beside the plain version's time and the bound.
 10. rwkv_train — rwkv6-7b at full width and depth 4 (AdamW on all 32
               layers would need 122 GB) through the same training loop
               and checks as phase 7: the WKV plan ``pallas``, steps x 4 x
               2 kernel launches, 0 plain calls, peak memory under
               RWKV_PEAK_LIMIT.
 11. rwkv_train_xcheck — one full-width train step at depth 2, b 1 x n
               1024, through the kernel and through the exact scan: loss
               and every gradient within XCHECK_TOL, and the scan with
               every time-mix V negated not.
 12. rwkv_forward — the eval / prefill forward at full width and full
               depth (32 layers), b 2 x n 1024, under no_grad: 32 kernel
               launches, finite logits; at the same parameters, in bf16
               and float32 compute, every block through the kernel
               against the same block through the exact scan from the
               scan's input: float32 blocks within RWKV_BLOCK_REL, the
               last layer's logits within 5% of the scan's largest, a
               V-negated control outside; free running in float32, the
               kernel path no further from the scan than RWKV_FREE_RATIO
               times the plain chunked version's path.  The float32
               checks at two seeds.

Then the ``kernels`` summary line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.  TF32 is off for matmuls and cuDNN.

    python3 chip_smoke.py --only parity [--src OTHER/src]
    python3 chip_smoke.py --only wkv_parity [--src OTHER/src]

run phases 1, 2 and 3 (or 9) alone, against the package under ``--src``
(by default this checkout's): another commit's kernels checked and timed
by this script's phase.  Against another package, phase 3 records the
launch grids without holding them to the split design.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, float32
# outside the tensor cores (an FMA counted as two operations), bf16 on the
# tensor cores (dense)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12
# float32 instructions that are not FMAs (add, max) issue at one per lane
# and cycle: 132 SMs x 128 lanes x 1.98 GHz boost, half the FMA rate above
FP32_INSTR_PER_S = 132 * 128 * 1.98e9
# TF32 on the tensor cores (dense), and the special-function units (exp2,
# log2): 16 a cycle per SM
TF32_TENSOR_OPS_PER_S = 495e12
MUFU_PER_S = 132 * 16 * 1.98e9
# TF32 passes a float32 product takes at float32 accuracy (hi/lo split)
TF32_PASSES = 3
# float32 operations per (query head, attendable key, head dim) element.
# Softmax: two FMAs (q.k and p.v), at FP32_OPS_PER_S.  Both inhibitor
# kernels: instructions at FP32_INSTR_PER_S, the least that compute it:
# t = q - k and s += |t| (|t| an operand modifier of the add) for the
# score; m = min(|v|, z) and acc = fma(-sgn v, m, acc) for the
# inhibition, since for z >= 0 (v > 0 ? relu(v - z) : min(v + z, 0)) =
# v - sgn(v) min(|v|, z) term by term (v > 0: v - z or 0; v < 0: v + z or
# 0; v = 0: 0; z = +inf: 0), and unsigned relu(v - z) = v - min(v, z).
# The sum of v over the attended keys is shared by the query heads of a
# kv head (flash: a prefix sum shared by every query): the bounds add one
# add per (kv head, key, d) and one per (query head, query, d).
OPS_PER_ELEMENT = {"paged_inhibitor": 4, "paged_attention": 4,
                   "flash_inhibitor": 4, "flash_attention": 4}

H, H_KV, D, PS, BATCH, WIDTH = 9, 3, 64, 16, 8, 32
LENGTHS = [1, 15, 16, 17, 100, 300, 511, 512]
SHARED_ROWS, SHARED_PAGES = (5, 6), 10     # rows 5 and 6 share 160 tokens
LAYERS = 30                                # pools cycled when timing
WINDOW = 64


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, n: int, warm: int = 3) -> float:
    """Mean milliseconds per call of fn(i), by CUDA events."""
    import torch

    for i in range(warm):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


# runtime calls that put work on the card, and the device records they make
DEVICE_WORK_CALLS = ("Launch", "Memcpy", "Memset")
DEVICE_RECORDS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_us(fn, n: int, grids: bool = False, attempts: int = 3) -> dict:
    """Device time per call of fn(i) without the host: the device records
    (kernels, copies, fills) of n calls in a torch.profiler trace, summed
    and divided by n, with the records per call, the mean per record and,
    with ``grids``, each kernel's launch grids as the trace recorded them.

    The n calls run inside a recorded range, and only the records whose
    correlation ids match a runtime call made inside that range count.
    On the H100 the trace drops the first records of a session, more the
    longer the process has run (a handful after a few minutes), so the
    range follows ``pad`` tiny fills; a trace in which any call of the range
    lost its record is taken again with four times the pad, and after
    ``attempts`` such traces the phase fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    fill = torch.zeros(1, device="cuda")
    pad = 1000
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(pad):
                fill.zero_()
            torch.cuda.synchronize()
            with record_function("device_us"):
                for i in range(n):
                    fn(i)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        span = [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("name") == "device_us"
                and e.get("cat") == "user_annotation"]
        check(len(span) == 1, f"{len(span)} device_us ranges in the trace")
        lo, hi = span[0]
        calls = {e["args"]["correlation"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})
                 and lo <= e["ts"] <= hi
                 and any(w in e.get("name", "") for w in DEVICE_WORK_CALLS)}
        records = [e for e in events if e.get("cat") in DEVICE_RECORDS
                   and e.get("args", {}).get("correlation") in calls]
        lost = len(calls) - len(records)
        if records and lost == 0:
            break
        check(attempt < attempts, f"the profiler trace lost {lost} of the "
              f"{len(calls)} device records of the timed calls in each of "
              f"{attempts} traces (last pad {pad} fills)")
        pad *= 4
    total = sum(float(e["dur"]) for e in records)
    out = {"us": total / n, "kernels_per_call": len(records) / n,
           "us_per_launch": total / len(records), "trace_attempts": attempt}
    if grids:
        out["grids"] = {}
        for e in records:
            if e["cat"] == "kernel" and "grid" in e["args"]:
                seen = out["grids"].setdefault(e["name"], [])
                if e["args"]["grid"] not in seen:
                    seen.append(e["args"]["grid"])
    return out


def make_pools(gen, dtype, layers: int = 1, poison: bool = True,
               qk_std: float = 1.0, device: str = "cuda", heads: int = H):
    """Ragged paged pools in the engine's layout: per-row non-contiguous
    pages, trash page 0 for unmapped entries, rows 5/6 sharing their first
    pages; q (``heads`` query heads) and k of stddev ``qk_std``, v unit
    normal.  With ``poison``, the trash page and every row's tail past its
    cursor hold ±1e9.  Returns q, k_pool, v_pool, tables, lengths."""
    import torch

    num_pages = BATCH * WIDTH + 1
    shape = (layers, num_pages, PS, H_KV, D)
    kp = (torch.randn(shape, generator=gen, device=device) * qk_std).to(dtype)
    vp = torch.randn(shape, generator=gen, device=device).to(dtype)
    perm = (torch.randperm(num_pages - 1, generator=gen, device=device)
            + 1).tolist()
    tables = torch.zeros((BATCH, WIDTH), dtype=torch.int32)
    nxt = 0
    for row, ln in enumerate(LENGTHS):
        used = -(-ln // PS)
        tables[row, :used] = torch.tensor(perm[nxt:nxt + used])
        nxt += used
    a, b = SHARED_ROWS
    tables[b, :SHARED_PAGES] = tables[a, :SHARED_PAGES]
    if poison:
        kp[:, 0], vp[:, 0] = 1e9, -1e9
    for row, ln in enumerate(LENGTHS):
        tail = ln % PS
        if tail and poison:
            page = int(tables[row, ln // PS])
            kp[:, page, tail:], vp[:, page, tail:] = 1e9, -1e9
    q = (torch.randn((BATCH, 1, heads, D), generator=gen, device=device)
         * qk_std).to(dtype)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=device)
    return q, kp, vp, tables.to(device), lengths


def bound(name: str, q, tables, lengths, window, elem: int) -> dict:
    """Least time for the work these inputs need: K and V of each distinct
    (page, slot) position some row attends read once (rows sharing pages
    read them once between them), q read and out written once, the table
    entries walked and the lengths read once; the kernel's float32
    operations on the attendable keys of every query head (the
    inhibitor's as instructions, with the sum of v per kv head)."""
    positions, entries, ops = set(), 0, 0
    tab = tables.tolist()
    for row, ln in enumerate(lengths.tolist()):
        lo = max(0, ln - window) if window is not None else 0
        positions.update((tab[row][j // PS], j % PS) for j in range(lo, ln))
        entries += -(-ln // PS) - lo // PS
        ops += (ln - lo) * H * D * OPS_PER_ELEMENT[name]
        if name == "paged_inhibitor":
            ops += (ln - lo) * H_KV * D + H * D
    nbytes = (2 * len(positions) * H_KV * D * elem + 2 * q.numel() * elem
              + 4 * entries + 4 * lengths.numel())
    rate = FP32_INSTR_PER_S if name == "paged_inhibitor" else FP32_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


# inhibitor q and k have stddev 1/sqrt(d): the score Z = sum_d |q - k| /
# sqrt(d) - 0.5 is then about 0.6, so relu(v - Z) and min(v + Z, 0) are
# nonzero for a quarter to a half of unit-normal v.  At unit q and k, Z
# would be about 8.5 and every output exactly 0.  Softmax keeps unit q, k.
QK_STD = {"paged_inhibitor": D ** -0.5, "paged_attention": 1.0}
# least share of reference elements above the tolerance in every case
MIN_NONZERO_SHARE = 0.1
# query heads per kv head at which phase 3 also checks both split
# kernels (smollm-135m's is 3): llama4-scout and hymba-1.5b have 5, the
# kernels' largest is 8
SPLIT_GROUPS = (5, 8)


def kernel_fns(kpaged, name):
    if name == "paged_inhibitor":
        return (kpaged.paged_flash_inhibitor_fwd,
                kpaged.paged_flash_inhibitor_plain)
    return kpaged.paged_flash_attention_fwd, kpaged.paged_flash_attention_plain


def parity_checks(torch, kpaged, device: str = "cuda") -> dict:
    """Each kernel against its plain version on the same inputs.  Every
    case must also be non-vacuous: a share of the reference lies above
    the tolerance, and the reference on V pages shifted by one (a kernel
    reading the wrong pages) lies outside it."""
    gen = torch.Generator(device=device).manual_seed(0)
    results = {}
    # tolerances: float32 — summation order only, 1e-4 x max(1, |ref|)
    # (wider unnormalized, below); bfloat16 — kernel and plain round the
    # same float32 value, so two bf16 ulps (2 * 2^-7) x max(1, |ref|)
    for dtype, rel in ((torch.bfloat16, 2 * 2.0 ** -7), (torch.float32, 1e-4)):
        pools = {name: make_pools(gen, dtype, qk_std=QK_STD[name],
                                  device=device) for name in QK_STD}
        cases = [("paged_inhibitor", dict(signed=True), None),
                 ("paged_inhibitor", dict(signed=False), None),
                 ("paged_inhibitor", dict(signed=True, normalize=False), None),
                 ("paged_inhibitor", dict(signed=True), WINDOW),
                 ("paged_attention", {}, None),
                 ("paged_attention", {}, WINDOW)]
        # both split kernels at groups the smollm shape does not reach
        for group in SPLIT_GROUPS:
            for kernel, kws in (("paged_inhibitor", (dict(signed=True),
                                                     dict(signed=False))),
                                ("paged_attention", ({}, {}))):
                name = f"{kernel} group {group}"
                pools[name] = make_pools(gen, dtype, heads=group * H_KV,
                                         qk_std=QK_STD[kernel],
                                         device=device)
                cases += [(name, kws[0], None), (name, kws[1], WINDOW)]
        for label_name, kw, window in cases:
            name = label_name.split()[0]
            fwd, plain = kernel_fns(kpaged, name)
            q, kp, vp, tables, lengths = pools[label_name]
            out = fwd(q, kp[0], vp[0], tables, lengths, window=window, **kw)
            ref = plain(q, kp[0], vp[0], tables, lengths, window=window, **kw)
            control = plain(q, kp[0], vp[0].roll(1, dims=0), tables, lengths,
                            window=window, **kw)
            label = f"{label_name} {kw} window={window} {dtype}"
            check(bool(torch.isfinite(out).all()), f"{label}: non-finite")
            err = (out.float() - ref.float()).abs().max().item()
            tol = rel * max(1.0, ref.float().abs().max().item())
            if dtype == torch.float32 and not kw.get("normalize", True):
                # unnormalized, the plain version's eq. 9/10 form cancels
                # sums of up to max(LENGTHS) terms of size |V| + Z ~ 3:
                # its own rounding grows with the key count
                tol *= max(LENGTHS) / 8
            share = (ref.float().abs() > tol).float().mean().item()
            ctl_err = (control.float() - ref.float()).abs().max().item()
            check(err <= tol, f"{label}: max_abs_err {err} > tol {tol}")
            check(share >= MIN_NONZERO_SHARE,
                  f"{label}: only {share} of the reference exceeds tol")
            check(ctl_err > tol, f"{label}: wrong-page control within tol")
            r = results.setdefault(name, {"max_abs_err": 0.0, "tol": {},
                                          "cases": 0, "min_nonzero_share": 1.0,
                                          "min_control_err_over_tol": None})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["tol"][str(dtype).replace("torch.", "")] = rel
            r["cases"] += 1
            r["min_nonzero_share"] = min(r["min_nonzero_share"], share)
            ratio = ctl_err / tol
            if (r["min_control_err_over_tol"] is None
                    or ratio < r["min_control_err_over_tol"]):
                r["min_control_err_over_tol"] = ratio
        # nan in the trash page and past every cursor must not change a bit
        for label_name in pools:
            fwd, _ = kernel_fns(kpaged, label_name.split()[0])
            q, kp, vp, tables, lengths = pools[label_name]
            clean = fwd(q, kp[0], vp[0], tables, lengths)
            kn, vn = kp[0].clone(), vp[0].clone()
            for t in (kn, vn):
                t[0] = float("nan")
                for row, ln in enumerate(LENGTHS):
                    if ln % PS:
                        t[int(tables[row, ln // PS]), ln % PS:] = float("nan")
            check(torch.equal(fwd(q, kn, vn, tables, lengths), clean),
                  f"{label_name} kernel read a masked position (nan poison)")
    for name in ("paged_inhibitor", "paged_attention"):
        results[name]["groups"] = [H // H_KV, *SPLIT_GROUPS]
    return results


def phase_parity(torch, kpaged, check_grids: bool = True):
    """parity_checks, then each kernel timed at the main path's shapes.
    With ``check_grids``, each split kernel's launch grid in the trace
    must be (batch x kv heads, ceil(width / pages per split)) over more
    blocks than the card has SMs; without, the grids are only recorded
    (another commit's kernels)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)
    results = parity_checks(torch, kpaged)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    # timing at the main path's shapes and dtype: bf16, cycling over 30
    # layers' pools (96 MB, beyond the 50 MB L2) as a decode tick does.
    # Unpoisoned: the library yardstick (scaled_dot_product_attention with
    # a bool mask) lets a masked key of magnitude 1e9 through on the card,
    # so it computes the same function only on clean pools
    n = 300
    timings = {}
    for name in ("paged_inhibitor", "paged_attention"):
        fwd, plain = kernel_fns(kpaged, name)
        q, kp, vp, tables, lengths = make_pools(
            gen, torch.bfloat16, LAYERS, poison=False, qk_std=QK_STD[name])

        def kernel(i):
            return fwd(q, kp[i % LAYERS], vp[i % LAYERS], tables, lengths)

        t = {"ms": cuda_ms(kernel, n),
             "plain_ms": cuda_ms(lambda i: plain(
                 q, kp[i % LAYERS], vp[i % LAYERS], tables, lengths), 30)}
        dev = device_us(kernel, 100, grids=True)
        t["device_us"], t["kernels_per_call"] = (dev["us"],
                                                 dev["kernels_per_call"])
        t["trace_attempts"] = dev["trace_attempts"]
        t["grids"] = dev["grids"]
        # the split kernel's grid as launched: (row x kv head, split)
        grid = [g for k, gs in dev["grids"].items()
                if f"{name}_split_kernel" in k for g in gs]
        if check_grids:
            check(len(grid) == 1, f"{name}: split kernel grids "
                  f"{dev['grids']} in the trace, expected one")
            t["splits"] = grid[0][1]
            t["blocks"] = math.prod(grid[0])
            check(t["splits"] == kpaged.attention_splits(
                WIDTH, kpaged.DEFAULT_PAGES_PER_STEP)
                and t["blocks"] > sms, f"{name}: launched grid "
                f"{grid[0]}, expected (batch x kv heads, ceil(width / "
                f"pages per split)) over more blocks than the {sms} SMs")
        if name == "paged_attention":
            group = H // H_KV
            mask = (torch.arange(WIDTH * PS, device="cuda")[None]
                    < lengths.long()[:, None])[:, None, None, :]

            def library(i):
                idx = tables.long()
                k = kp[i % LAYERS][idx].reshape(BATCH, -1, H_KV, D)
                v = vp[i % LAYERS][idx].reshape(BATCH, -1, H_KV, D)
                k = k.transpose(1, 2).repeat_interleave(group, dim=1)
                v = v.transpose(1, 2).repeat_interleave(group, dim=1)
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k, v, attn_mask=mask)

            t["library_ms"] = cuda_ms(library, 100)
            dev = device_us(library, 100)
            t["library_device_us"] = dev["us"]
            t["library_kernels_per_call"] = dev["kernels_per_call"]
            lib_err = (library(0).transpose(1, 2).float() - fwd(
                q, kp[0], vp[0], tables, lengths).float()).abs().max().item()
            t["library_max_abs_err"] = lib_err
        else:
            t["library_ms"] = None
        t.update(bound(name, q, tables, lengths, None, 2))
        timings[name] = t
    emit({"phase": "parity", "shapes": {
        "heads": H, "kv_heads": H_KV, "head_dim": D, "page_size": PS,
        "batch": BATCH, "table_width": WIDTH, "lengths": LENGTHS,
        "shared_rows": SHARED_ROWS, "window": WINDOW},
        "results": results, "timings": timings})
    return results, timings


def phase_serve(torch, kops, arch: str):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import Engine, EngineConfig, Request

    cfg = get_config(arch)
    api = get_model(cfg)
    t0 = time.perf_counter()
    params = api.init(torch.Generator().manual_seed(0), device="cuda")
    init_s = time.perf_counter() - t0
    eng = Engine(api, params, EngineConfig(max_batch=8, max_len=512,
                                           page_size=16, prefix_cache=True),
                 device="cuda")
    check(eng.paged and eng.decode_plan.backend == "paged_pallas",
          f"{arch}: decode plan is {eng.decode_plan}")
    rng = np.random.default_rng(0)
    first_token = {}                 # request id -> wall time of token 1

    def on_token(req, tok):
        first_token.setdefault(req.request_id, time.perf_counter())

    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (128,)),
                    max_new_tokens=32, on_token=on_token) for i in range(8)]
    submitted = {}
    for r in reqs:
        eng.submit(r)
        submitted[r.request_id] = time.perf_counter()
    kops.reset_counts()
    tick_ms, decode_only_ms = [], []
    t0 = time.perf_counter()
    while eng.active or eng.admitting or len(eng.scheduler):
        chunks = eng.counters["prefill_chunks"]
        ticks = eng.counters["decode_ticks"]
        ts = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - ts) * 1e3
        tick_ms.append(dt)
        if (eng.counters["prefill_chunks"] == chunks
                and eng.counters["decode_ticks"] == ticks + 1):
            decode_only_ms.append(dt)
        check(len(tick_ms) < 1000, f"{arch}: engine did not drain")
    wall = time.perf_counter() - t0
    counts = kops.counts()
    stats = eng.stats()
    kernel = ("paged_inhibitor" if cfg.attention.mechanism.startswith(
        "inhibitor") else "paged_attention")
    other = ({"paged_inhibitor", "paged_attention"} - {kernel}).pop()
    ticks = stats["decode_ticks"]
    check(all(r.output is not None and len(r.output) == 32 for r in reqs),
          f"{arch}: not every request finished with 32 tokens")
    check(counts[kernel] == ticks * cfg.num_layers,
          f"{arch}: {kernel} launched {counts[kernel]} times, expected "
          f"{ticks} ticks x {cfg.num_layers} layers")
    check(all(n == 0 for name, n in counts.items() if name != kernel),
          f"{arch}: unexpected launches {counts}")
    gen_tokens = stats["generated_tokens"]
    out = {"phase": "serve", "arch": arch, "init_s": init_s,
           "requests": len(reqs), "prompt_len": 128, "new_tokens": 32,
           "generated_tokens": gen_tokens, "wall_s": wall,
           "tok_per_s": gen_tokens / wall, "ticks": len(tick_ms),
           "decode_ticks": ticks, "prefill_chunks": stats["prefill_chunks"],
           "decode_tick_ms_p50": statistics.median(decode_only_ms),
           "decode_only_ticks": len(decode_only_ms),
           "ttft_ms_p50": statistics.median(
               (first_token[i] - submitted[i]) * 1e3 for i in submitted),
           "itl_ms_p50": stats["itl_ms_p50"], "launches": counts,
           "high_water_pages": stats["high_water_pages"],
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    emit(out)
    del eng, params
    torch.cuda.empty_cache()
    return kernel, counts[kernel], out


def decode_paths(torch, cfg, params, lengths, gen, device: str = "cuda"):
    """One paged decode step through the paged kernel and through the
    forced gather backend on the same state, plus a control: the kernel
    path again after the pool's cached V rows are zeroed.  For the
    inhibitor, wq, wk and the pool's K are scaled to stddev 1/sqrt(d)
    (see QK_STD): at unit scale every inhibition is exactly 0 and the
    check would hold for a kernel that writes zeros.  Returns float32
    logits by path."""
    import dataclasses

    from repro_torch.launch.profile import build_state
    from repro_torch.models import transformer as tfm

    st = build_state(cfg, lengths, page_size=PS, max_len=512, gen=gen,
                     device=device)
    kv = st.kv
    if cfg.attention.mechanism.startswith("inhibitor"):
        std = cfg.attention.head_dim ** -0.5
        kv.k.mul_(std)
        for blk in params["blocks"]:
            blk["attn"]["wq"]["kernel"].mul_(std)
            blk["attn"]["wk"]["kernel"].mul_(std)
    tokens = torch.randint(0, cfg.vocab_size, (len(lengths), 1),
                           generator=gen, device=device)
    k0, v0 = kv.k.clone(), kv.v.clone()
    gather_cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, backend="paged"))
    logits = {}
    for path, run_cfg, v_init in (("kernel", cfg, v0),
                                  ("gather", gather_cfg, v0),
                                  ("control", cfg, torch.zeros_like(v0))):
        kv.k.copy_(k0)
        kv.v.copy_(v_init)
        lg, _ = tfm.lm_step(params, run_cfg, tokens, st)
        logits[path] = lg.float()
    return logits


def phase_decode_paths(torch):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm

    out = {"phase": "decode_paths"}
    gen = torch.Generator(device="cuda").manual_seed(1)
    lengths = [0, 14, 15, 16, 99, 299, 500, 510]     # cursors before the step
    for arch in ("smollm-135m@inhibitor", "smollm-135m"):
        cfg = get_config(arch)
        params = tfm.init_lm(torch.Generator().manual_seed(1), cfg,
                             device="cuda")
        logits = decode_paths(torch, cfg, params, lengths, gen)
        torch.cuda.synchronize()
        ref = logits["gather"]
        err = (logits["kernel"] - ref).abs().max().item()
        ctl_err = (logits["control"] - ref).abs().max().item()
        scale = ref.abs().max().item()
        # bf16 compute through 30 layers: the kernel and the gather path
        # differ by rounding only, so allow 5% of the largest logit; the
        # control (cached V zeroed) must fall outside that
        tol = 0.05 * scale
        agree = (logits["kernel"].argmax(-1) == ref.argmax(-1)).float().mean()
        check(bool(torch.isfinite(logits["kernel"]).all()),
              f"{arch}: non-finite kernel-path logits")
        check(err <= tol, f"{arch}: kernel vs gather logits max_abs_err "
              f"{err} > tol {tol}")
        check(ctl_err > tol, f"{arch}: zeroed-V control logits within tol "
              f"({ctl_err} <= {tol}): attention does not reach the logits")
        out[arch] = {"max_abs_err": err, "tol": tol, "max_abs_logit": scale,
                     "control_max_abs_err": ctl_err,
                     "argmax_agreement": agree.item()}
        del params, logits
        torch.cuda.empty_cache()
    emit(out)


# ---------------------------------------------------------------------------
# blockwise flash kernels (the training forward)
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_N = 8, 1024                 # the train phase's batch x seq
TRAIN_STEPS, TRAIN_LR = 12, 1e-3
# least fall of the loss from the first to the last step on the fixed
# batch (PERF.md predicts a fall of 2 to 6 nats from ~10.9)
TRAIN_MIN_FALL = 1.0
# train_xcheck: max over parameters of |g_kernel - g_plain| / |g_plain|
# (and the loss's relative difference) in bf16 compute; the paths differ
# by float32 summation order inside attention, rounded to bf16 at its
# output and in the backward
XCHECK_TOL = 0.05
# flash parity tolerances, elementwise: float32 1e-5 + 1e-5 |ref|
# (summation order only; unnormalized, the plain chunked form's eq. 9/10
# cancels sums of up to n_k terms of size |V| + Z: 1e-5 x max(1, max
# |ref|) x n_k / 8); bf16 adds 2^-7 |ref|, one ulp of each element (the
# kernel and the plain version round float32 values that differ by the
# float32 tolerance)
FLASH_TOL = {"float32": "1e-5 + 1e-5|ref| (unnormalized: 1e-5 max(1, "
                        "max|ref|) n_k/8)",
             "bfloat16": "the float32 tolerance + 2^-7|ref|"}
CURSOR_OFFS, CURSOR_VALID = [0, 100, 250, 5], [37, 137, 300, 0]
# the inhibitor kernel's other branches, beside the cases both kernels
# share (kwargs, batch, n, head_dim): unnormalized; no mask (interior
# tiles but the ragged last); a window edge inside a 64-key tile,
# unsigned; head_dim 32 and 128 (their own micro-tile shapes), causal
FLASH_INHIBITOR_CASES = [
    ("flash_inhibitor", dict(normalize=False), 2, 1000, D),
    ("flash_inhibitor", dict(causal=False), 1, 1000, D),
    ("flash_inhibitor", dict(window=100, signed=False), 2, 1000, D),
    ("flash_inhibitor", dict(signed=True), 1, 1000, 32),
    ("flash_inhibitor", dict(signed=False, window=64), 1, 1000, 128),
]


def flash_fns(name):
    from repro_torch.kernels import flash as kflash
    from repro_torch.kernels import inhibitor as kinh

    if name == "flash_inhibitor":
        return kinh.flash_inhibitor_fwd, kinh.flash_inhibitor_plain
    return kflash.flash_attention_fwd, kflash.flash_attention_plain


def flash_operands(torch, gen, name, dtype, b, n_q, n_k=None, d=D):
    """q (b, n_q, 9, d), k / v (b, n_k, 3, d) on ``gen``'s device; q and
    k of stddev 1/sqrt(d) for the inhibitor (see QK_STD), 1 for the
    Softmax; v unit normal."""
    n_k = n_k or n_q
    std = d ** -0.5 if name == "flash_inhibitor" else 1.0

    def mk(shape, scale):
        return (torch.randn(shape, generator=gen, device=gen.device)
                * scale).to(dtype)

    return (mk((b, n_q, H, d), std), mk((b, n_k, H_KV, d), std),
            mk((b, n_k, H_KV, d), 1.0))


def flash_tol(torch, ref, dtype, n_k: int, normalize: bool = True):
    r = ref.float().abs()
    tol = 1e-5 + 1e-5 * r
    if not normalize:
        tol = torch.full_like(r, 1e-5 * max(1.0, r.max().item()) * n_k / 8)
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * r
    return tol


def flash_parity_checks(torch, device: str = "cuda") -> dict:
    """Each flash kernel against its plain version; every case non-vacuous
    (a share of the reference above the tolerance, and the reference on V
    rolled by one key outside it)."""
    gen = torch.Generator(device=device).manual_seed(2)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        cases = []      # (name, kwargs, batch, n, head_dim)
        for name in ("flash_inhibitor", "flash_attention"):
            inh = name == "flash_inhibitor"
            for kw in ([dict(signed=True), dict(signed=False)] if inh
                       else [{}]):
                cases.append((name, kw, 1, 1024, D))
            cases.append((name, dict(window=64), 2, 1000, D))
            if inh:
                cases += FLASH_INHIBITOR_CASES
        for name, kw, b, n, d in cases:
            fwd, plain = flash_fns(name)
            q, k, v = flash_operands(torch, gen, name, dtype, b, n, d=d)
            out = fwd(q, k, v, **kw)
            ref = plain(q, k, v, **kw)
            control = plain(q, k, v.roll(1, dims=1), **kw)
            record(torch, results, name, f"{kw} b={b} n={n} d={d} {dtype}",
                   out, ref, control, flash_tol(torch, ref, dtype, n,
                                                kw.get("normalize", True)))
        # ragged cursors; nan past every cursor must not change a bit
        offs = torch.tensor(CURSOR_OFFS, dtype=torch.int32, device=device)
        valid = torch.tensor(CURSOR_VALID, dtype=torch.int32, device=device)
        for name, d, kw in (("flash_inhibitor", D, {}),
                            ("flash_inhibitor", D, dict(signed=False,
                                                        normalize=False)),
                            ("flash_inhibitor", 32, {}),
                            ("flash_inhibitor", 128, {}),
                            ("flash_attention", D, {})):
            fwd, plain = flash_fns(name)
            q, _, _ = flash_operands(torch, gen, name, dtype, 4, 37, d=d)
            _, k, v = flash_operands(torch, gen, name, dtype, 4, 300, d=d)
            kn, vn = k.clone(), v.clone()
            for row, ln in enumerate(CURSOR_VALID):
                kn[row, ln:], vn[row, ln:] = float("nan"), float("nan")
            for window in (None, 64):
                cur = dict(kw, q_offset=offs, kv_valid_len=valid,
                           window=window)
                out = fwd(q, k, v, **cur)
                # (the plain version masks by multiplying: a CPU rehearsal
                # runs it in place of the kernel and skips this check)
                check(device == "cpu" or torch.equal(fwd(q, kn, vn, **cur),
                                                     out),
                      f"{name} d={d} {kw} read past a cursor (nan poison)")
                check(not out[3].any(), f"{name}: kv_valid_len 0 row not 0")
                ref = plain(q, k, v, **cur)
                record(torch, results, name,
                       f"cursors d={d} {kw} window={window} {dtype}", out,
                       ref, plain(q, k, v.roll(1, dims=1), **cur),
                       flash_tol(torch, ref, dtype, 300,
                                 kw.get("normalize", True)))
    for r in results.values():
        r["tol"] = FLASH_TOL
    return results


def record(torch, results, name, label, out, ref, control, tol):
    """Check one parity case and fold it into ``results[name]``."""
    check(bool(torch.isfinite(out).all()), f"{name} {label}: non-finite")
    err = (out.float() - ref.float()).abs()
    check(bool((err <= tol).all()),
          f"{name} {label}: max_abs_err {err.max().item()} beyond tol")
    share = (ref.float().abs() > tol).float().mean().item()
    check(share >= MIN_NONZERO_SHARE,
          f"{name} {label}: only {share} of the reference exceeds tol")
    ctl = ((control.float() - ref.float()).abs() / tol).max().item()
    check(ctl > 1.0, f"{name} {label}: shifted-V control within tol")
    r = results.setdefault(name, {"max_abs_err": 0.0, "cases": 0,
                                  "min_nonzero_share": 1.0,
                                  "min_control_err_over_tol": None})
    r["max_abs_err"] = max(r["max_abs_err"], err.max().item())
    r["cases"] += 1
    r["min_nonzero_share"] = min(r["min_nonzero_share"], share)
    if (r["min_control_err_over_tol"] is None
            or ctl < r["min_control_err_over_tol"]):
        r["min_control_err_over_tol"] = ctl


def flash_bound(name: str, b: int, n: int, elem: int) -> dict:
    """Least time at (b, n) causal: q, k, v read and out written once;
    the operations on each attended (query head, key) pair: the inhibitor
    as float32 instructions that are not FMAs on the CUDA cores (no tensor
    core computes a sum of absolute differences), the Softmax products on
    the bf16 tensor cores (float32: FMAs on the CUDA cores)."""
    nbytes = elem * (2 * b * n * H * D + 2 * b * n * H_KV * D)
    pairs = b * H * n * (n + 1) // 2
    ops = OPS_PER_ELEMENT[name] * pairs * D
    if name == "flash_inhibitor":   # the prefix sums of v, added per query
        ops += b * n * (H_KV + H) * D
    rate = (FP32_INSTR_PER_S if name == "flash_inhibitor"
            else FP32_OPS_PER_S if elem == 4 else BF16_TENSOR_OPS_PER_S)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def phase_flash_parity(torch):
    import torch.nn.functional as F

    from repro_torch.kernels import flash as kflash

    results = flash_parity_checks(torch)
    gen = torch.Generator(device="cuda").manual_seed(3)
    timings = {}
    for name in ("flash_inhibitor", "flash_attention"):
        fwd, plain = flash_fns(name)
        # four input sets (100 MB, beyond the 50 MB L2), cycled
        sets = [flash_operands(torch, gen, name, torch.bfloat16, TRAIN_B,
                               TRAIN_N) for _ in range(4)]
        t = {"ms": cuda_ms(lambda i: fwd(*sets[i % 4]), 40),
             "plain_ms": cuda_ms(lambda i: plain(*sets[i % 4]), 3, warm=1)}
        dev = device_us(lambda i: fwd(*sets[i % 4]), 20)
        t["device_us"], t["kernels_per_call"] = (dev["us"],
                                                 dev["kernels_per_call"])
        t["trace_attempts"] = dev["trace_attempts"]
        # the train phase's exact shapes and dtype, held like the cases above
        q, k, v = sets[0]
        ref = plain(q, k, v)
        record(torch, results, name, f"train shapes b={TRAIN_B} "
               f"n={TRAIN_N} bf16", fwd(q, k, v), ref,
               plain(q, k, v.roll(1, dims=1)),
               flash_tol(torch, ref, torch.bfloat16, TRAIN_N))
        if name == "flash_attention":
            def library(i):
                q, k, v = (x.transpose(1, 2) for x in sets[i % 4])
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)

            t["library_ms"] = cuda_ms(library, 40)
            dev = device_us(library, 20)
            t["library_device_us"] = dev["us"]
            t["library_kernels_per_call"] = dev["kernels_per_call"]
            t["library_max_abs_err"] = (
                library(0).transpose(1, 2).float()
                - fwd(*sets[0]).float()).abs().max().item()
        else:
            t["library_ms"] = None
        t.update(flash_bound(name, TRAIN_B, TRAIN_N, 2))
        timings[name] = t
    emit({"phase": "flash_parity", "heads": H, "kv_heads": H_KV,
          "head_dim": D, "cursors": {"q_offset": CURSOR_OFFS,
                                     "kv_valid_len": CURSOR_VALID},
          "timing_shapes": {"batch": TRAIN_B, "n": TRAIN_N,
                            "causal": True, "dtype": "bfloat16",
                            "flash_attention_block_q": kflash.DEFAULT_BLOCK_Q},
          "results": results, "timings": timings})
    return results, timings


def train_kernel(cfg) -> str:
    return ("flash_inhibitor" if cfg.attention.mechanism.startswith(
        "inhibitor") else "flash_attention")


def phase_train(torch, kops, arch: str):
    """One arm through the training loop at full width and depth, fitting
    one fixed batch: at a 49152-token vocabulary the stream's bigrams take
    thousands of steps to learn, so a few steps on fresh batches leave
    the loss at ln(49152) ~ 10.8, while a batch trained on repeatedly is
    fitted in a few steps, and only by correct gradients."""
    from repro_torch.configs import get_config
    from repro_torch.core.mechanism import AttnShapes, plan_attention

    cfg = get_config(arch)
    a = cfg.attention
    plan = plan_attention(a, AttnShapes(
        batch=TRAIN_B, n_q=TRAIN_N, n_k=TRAIN_N, num_heads=a.num_heads,
        num_kv_heads=a.num_kv_heads, head_dim=a.head_dim, dtype=cfg.cdtype,
        platform="cuda"))
    check(plan.backend == "pallas" and a.backend is None,
          f"{arch}: training plan is {plan}")
    return train_fixed_batch(torch, kops, cfg, train_kernel(cfg), arch,
                             plan.backend)


def train_fixed_batch(torch, kops, cfg, kernel: str, arch: str, plan: str):
    """TRAIN_STEPS steps of ``repro_torch.train.loop.train`` (the loop the
    training launcher runs, with its optimizer) on one batch TRAIN_B x
    TRAIN_N of the seeded LM stream, remat "full".  ``kernel`` must
    launch steps x layers x 2 times (forward and remat recompute), every
    other kernel and every plain version never; every loss finite and the
    last below the first by TRAIN_MIN_FALL."""
    from repro_torch.data.pipeline import PipelineConfig, lm_batch_at
    from repro_torch.models.registry import get_model
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.train.loop import TrainConfig, train

    check(cfg.remat == "full", f"{arch}: remat is {cfg.remat!r}")
    batch = lm_batch_at(PipelineConfig(TRAIN_B, TRAIN_N, cfg.vocab_size,
                                       seed=0), 0)
    # the launcher's optimizer: AdamW, warmup_cosine(lr, 10, steps)
    opt_cfg = AdamWConfig(lr=warmup_cosine(TRAIN_LR, 10, TRAIN_STEPS))
    torch.cuda.reset_peak_memory_stats()
    kops.reset_counts()
    t0 = time.perf_counter()
    result = train(get_model(cfg), opt_cfg,
                   TrainConfig(total_steps=TRAIN_STEPS, seed=0),
                   lambda step: batch, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kops.counts()
    hist = result["history"]
    losses = [h["loss"] for h in hist]
    walls = [h["seconds"] for h in hist[1:]]
    # each step runs every layer's forward twice: once, and once more in
    # the backward (remat "full" recomputes the block)
    expected = TRAIN_STEPS * cfg.num_layers * 2
    check(counts[kernel] == expected,
          f"{arch}: {kernel} launched {counts[kernel]} times, expected "
          f"{TRAIN_STEPS} steps x {cfg.num_layers} layers x 2")
    check(all(n == 0 for name, n in counts.items() if name != kernel),
          f"{arch}: unexpected launches or plain calls {counts}")
    check(all(math.isfinite(x) for x in losses), f"{arch}: losses {losses}")
    check(losses[-1] < losses[0] - TRAIN_MIN_FALL,
          f"{arch}: loss fell {losses[0] - losses[-1]} < {TRAIN_MIN_FALL}")
    p50 = statistics.median(walls)
    out = {"phase": "train", "arch": arch, "layers": cfg.num_layers,
           "plan": plan, "steps": TRAIN_STEPS, "batch": TRAIN_B,
           "seq": TRAIN_N, "lr": TRAIN_LR, "seconds": seconds,
           "launches": counts, "losses": losses,
           "step_wall_s": [h["seconds"] for h in hist],
           "step_wall_ms_p50": p50 * 1e3,
           "tokens_per_s": TRAIN_B * TRAIN_N / p50,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit(out)
    del result
    torch.cuda.empty_cache()
    return kernel, counts[kernel], out


def phase_train_xcheck(torch, kops):
    """One train step's loss and gradients, kernel path vs plain path, at
    full width, depth 2, b 1 x n 1024."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, lm_batch_at
    from repro_torch.models import transformer as tfm
    from repro_torch.models.registry import get_model
    from repro_torch.train.step import make_grad_fn
    from repro_torch.tree import tree_leaves

    out = {"phase": "train_xcheck", "tol": XCHECK_TOL}
    for arch, plain_backend in (("smollm-135m@inhibitor", "chunked"),
                                ("smollm-135m", "fused")):
        cfg = dataclasses.replace(get_config(arch), num_layers=2)
        plain_cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, backend=plain_backend))
        params = tfm.init_lm(torch.Generator().manual_seed(0), cfg,
                             device="cuda")
        if cfg.attention.mechanism.startswith("inhibitor"):
            # q, k of stddev 1/sqrt(d): Z near 0.6 (see QK_STD); at the
            # init scale every inhibition and every wq / wk gradient is 0
            for blk in params["blocks"]:
                blk["attn"]["wq"]["kernel"].mul_(D ** -0.5)
                blk["attn"]["wk"]["kernel"].mul_(D ** -0.5)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        batch = {k: torch.from_numpy(v).cuda() for k, v in lm_batch_at(
            PipelineConfig(1, TRAIN_N, cfg.vocab_size, seed=0), 0).items()}
        kernel = train_kernel(cfg)
        kops.reset_counts()
        g_k, m_k = make_grad_fn(get_model(cfg))(params, batch)
        launches = kops.counts()[kernel]
        g_p, m_p = make_grad_fn(get_model(plain_cfg))(params, batch)
        with torch.no_grad():
            for blk in params["blocks"]:
                blk["attn"]["wv"]["kernel"].neg_()
        g_c, _ = make_grad_fn(get_model(plain_cfg))(params, batch)
        counts = kops.counts()
        check(launches == 2 * cfg.num_layers and counts[kernel] == launches
              and counts[kernel + "_plain"] == 0,
              f"{arch}: xcheck launches {counts}")

        def rel(a, b):
            return max(((x.float() - y.float()).norm()
                        / y.float().norm().clamp(min=1e-30)).item()
                       for x, y in zip(tree_leaves(a), tree_leaves(b)))

        err, ctl = rel(g_k, g_p), rel(g_c, g_p)
        loss_k, loss_p = m_k["loss"].item(), m_p["loss"].item()
        wq = g_k["blocks"][0]["attn"]["wq"]["kernel"].float().norm().item()
        check(all(bool(torch.isfinite(x).all()) for x in tree_leaves(g_k)),
              f"{arch}: non-finite kernel-path gradients")
        check(abs(loss_k - loss_p) <= XCHECK_TOL * abs(loss_p),
              f"{arch}: loss {loss_k} vs plain {loss_p}")
        check(err <= XCHECK_TOL, f"{arch}: gradient rel err {err} > tol")
        check(ctl > XCHECK_TOL, f"{arch}: V-negated control within tol "
              f"({ctl})")
        check(wq > 0.0, f"{arch}: wq gradient is 0 (vacuous check)")
        out[arch] = {"plain_backend": plain_backend, "loss_kernel": loss_k,
                     "loss_plain": loss_p, "max_grad_rel_err": err,
                     "control_max_grad_rel_err": ctl, "wq_grad_norm": wq,
                     "launches": launches}
        del params, g_k, g_p, g_c
        torch.cuda.empty_cache()
    emit(out)


# ---------------------------------------------------------------------------
# RWKV-6: the WKV kernel, training at depth 4, the full-depth forward
# ---------------------------------------------------------------------------

RWKV = "rwkv6-7b"
# AdamW in float32 keeps 16 bytes per parameter (value, gradient, two
# moments): rwkv6-7b's 7.6 B parameters need 122 GB, beyond the card's
# 80; its first 4 layers with the embedding and head (1.42 B) need 23 GB
RWKV_TRAIN_LAYERS = 4
RWKV_XCHECK_LAYERS = 2
RWKV_FORWARD_B = 2
RWKV_FORWARD_SEEDS = (0, 1)
RWKV_PEAK_LIMIT = 70e9
# rwkv_forward: one block through the kernel against the same block
# through the exact scan from the same float32 input, relative L2 (the
# WKV outputs alone differ by ~7e-7: float32 summation order)
RWKV_BLOCK_REL = 1e-4
# rwkv_forward, free running: how many times as far from the exact scan
# as the plain chunked version's path the kernel path may end up
RWKV_FREE_RATIO = 2.0
# (batch, t, heads, head_dim, chunk): the reference's sweep
# (tests/test_kernels.py), t below one chunk, t = 1, t = 0, and
# rwkv6-7b's heads at a ragged t; then the kernel's edges: a last chunk of
# 24 positions (ending inside a 16-row tile), chunks of 16 and 64 (a last
# chunk of 22), a chunk of 20 (padded to 32 inside), and head_dim 8 / 16
# / 32 / 64 at a tail of 8
WKV_CASES = [(2, 50, 3, 16, 16), (2, 32, 2, 8, 8), (2, 17, 1, 16, 32),
             (2, 20, 64, 64, 32), (2, 1, 64, 64, 32), (2, 0, 64, 64, 32),
             (2, 300, 8, 64, 32), (2, 88, 4, 64, 32), (2, 100, 4, 64, 16),
             (2, 150, 4, 64, 64), (2, 70, 4, 32, 20), (2, 40, 4, 8, 32),
             (2, 40, 4, 16, 32), (2, 40, 4, 32, 32), (2, 40, 4, 64, 32)]
WKV_H, WKV_N, WKV_CHUNK = 64, 64, 32
# kernel vs plain version, float32 arithmetic in both: the plain version
# sums each exponent over its own segment where the kernel differences
# the chunk's cumulative sum, and sums in another order
WKV_REL = 5e-5
WKV_TOL = "5e-5 max(1, max|ref|), outputs and final state apart"


def wkv_operands(torch, gen, b, t, h, n, dtype, decay):
    """r, k, v (unit normal, in ``dtype``), the float32 decay w — "mixed":
    exp(-exp(2 N(0, 1))), from ~1 down to 0 in float32; "zero"; "near_one":
    exp(-exp(N(0, 1) - 6)), as at rwkv6-7b's init — and u unit normal."""
    def mk(*shape):
        return torch.randn(shape, generator=gen, device=gen.device)

    r, k, v = (mk(b, t, h, n).to(dtype) for _ in range(3))
    if decay == "zero":
        w = torch.zeros((b, t, h, n), device=gen.device)
    elif decay == "near_one":
        w = torch.exp(-torch.exp(mk(b, t, h, n) - 6.0))
    else:
        w = torch.exp(-torch.exp(2.0 * mk(b, t, h, n)))
    return r, k, v, w, mk(h, n)


def wkv_case(torch, results, label, ops, chunk):
    """The kernel against its plain version on ``ops``, outputs and final
    state; non-vacuous: a share of each reference above the tolerance, and
    the reference with V one step late (at t = 1: V of the other batch
    row) or u zeroed outside it."""
    from repro_torch.kernels import rwkv6 as krwkv6

    r, k, v, w, u = ops
    out, state = krwkv6.wkv6_chunked(*ops, chunk=chunk)
    ref_o, ref_s = krwkv6.wkv6_chunked_plain(*ops, chunk=chunk)
    check(out.dtype == state.dtype == torch.float32, f"wkv6 {label}: dtype")
    check(bool(torch.isfinite(out).all() and torch.isfinite(state).all()),
          f"wkv6 {label}: non-finite")
    check(out.shape == ref_o.shape and state.shape == ref_s.shape,
          f"wkv6 {label}: shapes")
    if r.shape[1] == 0:
        check(not state.any(), f"wkv6 {label}: t = 0 state not zero")
        results["cases"] += 1
        return
    late = v.roll(1, dims=1 if r.shape[1] > 1 else 0)
    controls = [krwkv6.wkv6_chunked_plain(r, k, late, w, u, chunk=chunk)[0],
                krwkv6.wkv6_chunked_plain(r, k, v, w, 0 * u, chunk=chunk)[0]]
    for got, ref in ((out, ref_o), (state, ref_s)):
        tol = WKV_REL * max(1.0, ref.abs().max().item())
        err = (got - ref).abs().max().item()
        share = (ref.abs() > tol).float().mean().item()
        check(err <= tol, f"wkv6 {label}: max_abs_err {err} > tol {tol}")
        check(share >= MIN_NONZERO_SHARE,
              f"wkv6 {label}: only {share} of the reference exceeds tol")
        results["max_abs_err"] = max(results["max_abs_err"], err)
        results["min_nonzero_share"] = min(results["min_nonzero_share"],
                                           share)
    tol = WKV_REL * max(1.0, ref_o.abs().max().item())
    ctl = min((c - ref_o).abs().max().item() / tol for c in controls)
    check(ctl > 1.0, f"wkv6 {label}: a control within tol")
    results["cases"] += 1
    if (results["min_control_err_over_tol"] is None
            or ctl < results["min_control_err_over_tol"]):
        results["min_control_err_over_tol"] = ctl


def wkv_chunk_ops(L: int, n: int) -> dict:
    """The least operations of one chunk of L positions of the chunked
    form, by the unit that does them.  ``tensor``: flops of its products,
    the carry (r 2^C) S 2 L n^2, the state update 2 L n^2, the strictly
    lower intra-chunk matrix L (L-1) n and A v L (L+1) n, one TF32 pass;
    ``mufu``: a log2 of each decay and the exps of r 2^C and k 2^{C_L - C}
    per (position, channel), one exp per channel for the chunk's decay;
    ``fp32``: other float32 instructions, the scan, the two scalings and
    the bonus's product and sum per (position, channel), and the state's
    decay n^2.  At L = 1 it is the recurrence S = diag(w) S + k^T v, o =
    r (S + diag(u) k^T v): 4 n^2 + 2 n flops of products."""
    if L == 0:
        return {"tensor": 0, "mufu": 0, "fp32": 0}
    return {"tensor": 4 * L * n * n + 2 * L * L * n, "mufu": 3 * L * n + n,
            "fp32": 5 * L * n + n * n}


def wkv_bound(b: int, t: int, h: int, n: int, elem: int) -> dict:
    """Least time for the WKV from a zero state: r, k, v (``elem`` bytes
    each), w and u read once, out and the final state written once in
    float32; beside the least time of its operations, each unit at its
    peak: products at the dense TF32 tensor-core rate times the
    TF32_PASSES a float32 product takes, logs and exps at the MUFU rate,
    the rest at one float32 instruction per lane and cycle.  The units
    run side by side, so the operations take the longest of the three, at
    the chunk length L that makes it least (the tensor term grows with L,
    the others fall with it: L = 2 at n = 64).  At the train shape (b 8,
    t 1024, 64 x 64, bf16): 478 MB, 0.143 ms, against 0.053 ms of TF32
    products (0.028 ms of MUFU, 0.037 ms of the rest): bound by bytes.
    Counted as one float32 operation each at the 67e12 FMA rate, the same
    work would take 0.145 ms."""
    nbytes = b * t * h * n * (3 * elem + 4 + 4) + b * h * n * n * 4 + h * n * 4
    rates = {"tensor": TF32_TENSOR_OPS_PER_S / TF32_PASSES,
             "mufu": MUFU_PER_S, "fp32": FP32_INSTR_PER_S}
    best = None
    for L in range(1, max(t, 1) + 1):
        full, tail = divmod(t, L)
        one, rest = wkv_chunk_ops(L, n), wkv_chunk_ops(tail, n)
        ops = {u: b * h * (full * one[u] + rest[u]) for u in rates}
        secs = {u: ops[u] / rates[u] for u in rates}
        if best is None or max(secs.values()) < best[0]:
            best = (max(secs.values()), L, ops, secs)
    t_ops, L, ops, secs = best
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "bytes_ms": t_bytes * 1e3, "ops": ops,
            "ops_ms": {u: x * 1e3 for u, x in secs.items()},
            "ops_chunk": L}


def phase_wkv_parity(torch):
    """The WKV kernel against its plain version over WKV_CASES, three
    decays, float32 and bf16 r/k/v; then at the train shape (b 8, t 1024,
    64 heads of 64, bf16 r/k/v) and the full-depth forward's (b 2) held
    the same way and timed: by CUDA events (ms, the host included) and by
    the kernel's device time in a profiler trace, with the trace's launch
    grid."""
    from repro_torch.kernels import rwkv6 as krwkv6

    gen = torch.Generator(device="cuda").manual_seed(4)
    results = {"max_abs_err": 0.0, "cases": 0, "min_nonzero_share": 1.0,
               "min_control_err_over_tol": None, "tol": WKV_TOL}
    for dtype in (torch.bfloat16, torch.float32):
        for b, t, h, n, chunk in WKV_CASES:
            for decay in ("mixed", "zero", "near_one"):
                wkv_case(torch, results, f"b={b} t={t} h={h} n={n} "
                         f"chunk={chunk} {decay} {dtype}",
                         wkv_operands(torch, gen, b, t, h, n, dtype, decay),
                         chunk)
    shapes = {}
    for label, batch in (("train", TRAIN_B), ("forward", RWKV_FORWARD_B)):
        # two input sets a shape (670 MB at the train shape, beyond the
        # 50 MB L2)
        sets = [wkv_operands(torch, gen, batch, TRAIN_N, WKV_H, WKV_N,
                             torch.bfloat16, "near_one"),
                wkv_operands(torch, gen, batch, TRAIN_N, WKV_H, WKV_N,
                             torch.bfloat16, "mixed")]
        for i, ops in enumerate(sets):
            wkv_case(torch, results, f"{label} shape b={batch} t={TRAIN_N} "
                     f"set {i} bf16", ops, WKV_CHUNK)
        dev = device_us(lambda i: krwkv6.wkv6_chunked(*sets[i % 2]), 20,
                        grids=True)
        shapes[label] = {
            "ms": cuda_ms(lambda i: krwkv6.wkv6_chunked(*sets[i % 2]), 40),
            "device_us": dev["us"],
            "kernels_per_call": dev["kernels_per_call"], "grid": dev["grids"],
            "trace_attempts": dev["trace_attempts"],
            "plain_ms": cuda_ms(lambda i: krwkv6.wkv6_chunked_plain(
                *sets[i % 2]), 3, warm=1),
            **wkv_bound(batch, TRAIN_N, WKV_H, WKV_N, 2)}
        del sets
    train, fwd = shapes["train"], shapes["forward"]
    timings = {"ms": train["ms"], "device_us": train["device_us"],
               "plain_ms": train["plain_ms"], "library_ms": None,
               "bound_ms": train["bound_ms"], "bound_by": train["bound_by"],
               "forward_ms": fwd["ms"], "forward_device_us": fwd["device_us"],
               "forward_bound_ms": fwd["bound_ms"]}
    emit({"phase": "wkv_parity", "cases": WKV_CASES,
          "decays": ["mixed", "zero", "near_one"],
          "timing_shapes": {"batch": {"train": TRAIN_B,
                                      "forward": RWKV_FORWARD_B},
                            "t": TRAIN_N, "heads": WKV_H, "head_dim": WKV_N,
                            "chunk": WKV_CHUNK, "dtype": "bfloat16"},
          "results": results, "timings": timings, "shapes": shapes})
    return results, timings


def phase_rwkv_train(torch, kops):
    """rwkv6-7b at full width and depth RWKV_TRAIN_LAYERS through the
    training loop, as the smollm arms; peak memory under RWKV_PEAK_LIMIT."""
    from repro_torch.configs import get_config
    from repro_torch.core.mechanism import kernel_native
    from repro_torch.models.rwkv import wkv_plan

    cfg = get_config(RWKV).with_layers(RWKV_TRAIN_LAYERS)
    # the registry's rule: the kernel where the tokens' device runs it
    plan = wkv_plan(kernel_native("wkv6", "cuda"), carried_state=False)
    check(plan.backend == "pallas", f"{RWKV}: WKV plan is {plan}")
    _, n, out = train_fixed_batch(torch, kops, cfg, "wkv6", RWKV,
                                  plan.backend)
    check(out["peak_memory_bytes"] < RWKV_PEAK_LIMIT,
          f"{RWKV}: peak memory {out['peak_memory_bytes']} bytes")
    return n, out


def phase_rwkv_xcheck(torch, kops):
    """One train step's loss and gradients at full width, depth
    RWKV_XCHECK_LAYERS, b 1 x n 1024: the kernel path against the plain
    path (the exact scan), and the plain path with every time-mix V
    negated outside the tolerance."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, lm_batch_at
    from repro_torch.models import rwkv as rwkv_m
    from repro_torch.models.registry import get_model
    from repro_torch.train.step import make_grad_fn
    from repro_torch.tree import tree_leaves

    cfg = get_config(RWKV).with_layers(RWKV_XCHECK_LAYERS)
    api = get_model(cfg)
    scan_api = api._replace(forward=lambda p, b: rwkv_m.lm_forward(
        p, cfg, b["tokens"], use_kernel=False))
    params = api.init(torch.Generator(device="cuda").manual_seed(0),
                      device="cuda")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v).cuda() for k, v in lm_batch_at(
        PipelineConfig(1, TRAIN_N, cfg.vocab_size, seed=0), 0).items()}
    kops.reset_counts()
    g_k, m_k = make_grad_fn(api)(params, batch)
    launches = kops.counts()["wkv6"]
    g_p, m_p = make_grad_fn(scan_api)(params, batch)
    with torch.no_grad():
        for blk in params["blocks"]:
            blk["time_mix"]["value"]["kernel"].neg_()
    g_c, _ = make_grad_fn(scan_api)(params, batch)
    counts = kops.counts()
    check(launches == 2 * cfg.num_layers and counts["wkv6"] == launches
          and counts["wkv6_plain"] == 0, f"{RWKV}: xcheck launches {counts}")

    def rel(a, b):
        return max(((x.float() - y.float()).norm()
                    / y.float().norm().clamp(min=1e-30)).item()
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    err, ctl = rel(g_k, g_p), rel(g_c, g_p)
    loss_k, loss_p = m_k["loss"].item(), m_p["loss"].item()
    u = g_k["blocks"][0]["time_mix"]["u"].float().norm().item()
    check(all(bool(torch.isfinite(x).all()) for x in tree_leaves(g_k)),
          f"{RWKV}: non-finite kernel-path gradients")
    check(abs(loss_k - loss_p) <= XCHECK_TOL * abs(loss_p),
          f"{RWKV}: loss {loss_k} vs plain {loss_p}")
    check(err <= XCHECK_TOL, f"{RWKV}: gradient rel err {err} > tol")
    check(ctl > XCHECK_TOL, f"{RWKV}: V-negated control within tol ({ctl})")
    check(u > 0.0, f"{RWKV}: u gradient is 0 (vacuous check)")
    out = {"phase": "rwkv_train_xcheck", "tol": XCHECK_TOL,
           "layers": cfg.num_layers, "plain_path": "exact scan",
           "loss_kernel": loss_k, "loss_plain": loss_p,
           "max_grad_rel_err": err, "control_max_grad_rel_err": ctl,
           "u_grad_norm": u, "launches": launches}
    emit(out)
    del params, g_k, g_p, g_c
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def plain_wkv():
    """Route the time-mix's WKV call (``kernels.ops.wkv6``) through the
    kernel's plain chunked version, on the card, while the block runs."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import rwkv6 as krwkv6

    kernel = kops.wkv6
    kops.wkv6 = lambda r, k, v, w, u, state=None: (
        krwkv6.wkv6_chunked_plain(r, k, v, w, u))
    try:
        yield
    finally:
        kops.wkv6 = kernel


def rwkv_paths(torch, params, cfg, tokens, free: bool):
    """The forward through the exact scan (the reference trajectory), with
    at every layer the same block through the kernel from the scan's
    input (teacher-forced).  With ``free``, two free-running paths beside
    it: through the kernel, and through the kernel's plain chunked
    version.  Returns the logits (teacher-forced kernel from the last
    layer's scan input, and the scan's), and per layer the relative
    difference ||y - y_scan|| / ||y_scan|| of the teacher-forced block
    outputs and of the free-running hidden states, all float32."""
    from repro_torch.models import rwkv as rwkv_m

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    x_s = x_k = x_p = rwkv_m._embed(params, cfg, tokens)
    div = {"teacher_forced_block_rel": []}
    if free:
        div.update(free_kernel_rel=[], free_plain_rel=[],
                   free_kernel_vs_plain_rel=[])
    for lp in params["blocks"]:
        y_tf = rwkv_m.apply_block(lp, cfg, x_s, use_kernel=True)[0]
        if free:
            x_k = rwkv_m.apply_block(lp, cfg, x_k, use_kernel=True)[0]
            with plain_wkv():
                x_p = rwkv_m.apply_block(lp, cfg, x_p, use_kernel=True)[0]
        x_s = rwkv_m.apply_block(lp, cfg, x_s, use_kernel=False)[0]
        div["teacher_forced_block_rel"].append(rel(y_tf, x_s))
        if free:
            div["free_kernel_rel"].append(rel(x_k, x_s))
            div["free_plain_rel"].append(rel(x_p, x_s))
            div["free_kernel_vs_plain_rel"].append(rel(x_k, x_p))
    lg = {"forced": rwkv_m._logits(params, cfg, y_tf).float(),
          "scan": rwkv_m._logits(params, cfg, x_s).float()}
    if free:
        top = lg["scan"].argmax(-1)
        for name, x in (("kernel", x_k), ("plain", x_p)):
            lf = rwkv_m._logits(params, cfg, x).float()
            div[f"free_{name}_max_abs_err"] = (
                lf - lg["scan"]).abs().max().item()
            div[f"free_{name}_argmax_agreement"] = (
                lf.argmax(-1) == top).float().mean().item()
            del lf
    return lg, div


def phase_rwkv_forward(torch, kops):
    """The eval / prefill forward of rwkv6-7b at full width and full depth
    (32 layers, float32 parameters drawn on the card), batch
    RWKV_FORWARD_B x TRAIN_N, under no_grad, through the registry's
    forward: 32 WKV launches, finite logits.  Then, at the same
    parameters, in bf16 and in float32 compute, the kernel against the
    exact scan layer by layer: from the scan's input at every layer (the
    reference trajectory), the kernel block's output within
    RWKV_BLOCK_REL of the scan block's in float32, and the logits of the
    last layer through the kernel within 5% of the scan forward's largest
    logit; the same with every time-mix V negated outside that.  Free
    running in float32, float32 rounding differences of the WKV output
    grow through the depth from rwkv6-7b's init until the chunked form
    and the scan part at a few positions (see PERF.md): at every layer
    the kernel path may part from the scan at most RWKV_FREE_RATIO times
    as far as the plain chunked version does, plus RWKV_BLOCK_REL.  The
    float32 checks run at each of RWKV_FORWARD_SEEDS (parameters, and
    the token batch from the next seed)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, lm_batch_at
    from repro_torch.models.registry import get_model

    cfg = get_config(RWKV)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    api = get_model(cfg)
    out = {"phase": "rwkv_forward", "layers": cfg.num_layers,
           "batch": RWKV_FORWARD_B, "seq": TRAIN_N,
           "free_ratio": RWKV_FREE_RATIO}
    checks = []
    for seed in RWKV_FORWARD_SEEDS:
        t0 = time.perf_counter()
        params = api.init(torch.Generator(device="cuda").manual_seed(seed),
                          device="cuda")
        torch.cuda.synchronize()
        run = {"init_s": time.perf_counter() - t0}
        tokens = torch.from_numpy(lm_batch_at(PipelineConfig(
            RWKV_FORWARD_B, TRAIN_N, cfg.vocab_size, seed=seed + 1),
            0)["tokens"]).cuda()
        with torch.no_grad():
            if seed == RWKV_FORWARD_SEEDS[0]:
                torch.cuda.reset_peak_memory_stats()
                kops.reset_counts()
                t0 = time.perf_counter()
                logits = api.forward(params, {"tokens": tokens})
                torch.cuda.synchronize()
                out["wall_ms"] = (time.perf_counter() - t0) * 1e3
                counts = kops.counts()
                out.update(launches=counts, peak_memory_bytes=(
                    torch.cuda.max_memory_allocated()))
                finite = bool(torch.isfinite(logits).all())
                del logits
                dtypes = ("bfloat16", "float32")
            else:
                dtypes = ("float32",)
            for dtype in dtypes:
                lg, div = rwkv_paths(
                    torch, params, dataclasses.replace(
                        cfg, compute_dtype=dtype), tokens,
                    free=dtype == "float32")
                scale = lg["scan"].abs().max().item()
                run[dtype] = {"max_abs_logit": scale, "tol": 0.05 * scale,
                              "max_abs_err": (lg["forced"] - lg["scan"])
                              .abs().max().item(), **div}
                checks.append((f"seed {seed} {dtype}", dtype, run[dtype]))
                scan32 = lg["scan"]
                del lg
            # control: every time-mix V negated, the kernel forward
            # against the float32 scan logits of the true parameters
            for blk in params["blocks"]:
                blk["time_mix"]["value"]["kernel"].neg_()
            ctl = get_model(cfg32).forward(params, {"tokens": tokens}).float()
            run["float32"]["control_max_abs_err"] = (
                ctl - scan32).abs().max().item()
            # the largest ratio the free-running check holds to
            # RWKV_FREE_RATIO (plus RWKV_BLOCK_REL)
            r32 = run["float32"]
            r32["free_kernel_over_plain_max"] = max(
                (k / p for k, p in zip(r32["free_kernel_rel"],
                                       r32["free_plain_rel"]) if p > 0),
                default=None)
            del ctl, scan32
        out[f"seed_{seed}"] = run
        del params, tokens
        torch.cuda.empty_cache()
    emit(out)
    check(counts["wkv6"] == cfg.num_layers
          and all(n == 0 for name, n in counts.items() if name != "wkv6"),
          f"{RWKV}: full-depth forward launches {counts}")
    check(finite, f"{RWKV}: non-finite logits")
    for label, dtype, r in checks:
        check(r["max_abs_err"] <= r["tol"], f"{RWKV} {label}: kernel vs "
              f"scan logits {r['max_abs_err']} > tol {r['tol']}")
        if dtype != "float32":
            continue
        check(max(r["teacher_forced_block_rel"]) <= RWKV_BLOCK_REL,
              f"{RWKV} {label}: a block through the kernel is off the "
              "scan's")
        check(all(k <= RWKV_FREE_RATIO * p + RWKV_BLOCK_REL for k, p in zip(
            r["free_kernel_rel"], r["free_plain_rel"])),
              f"{RWKV} {label}: the free-running kernel path parts from "
              "the scan further than the plain chunked version does")
        check(r["control_max_abs_err"] > r["tol"],
              f"{RWKV} {label}: V-negated control within tol")
    return counts["wkv6"], out


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, default=SRC,
                    help="the directory holding repro_torch (default: the "
                    "checkout's src/), e.g. another commit's, to time its "
                    "kernels with this script's phases")
    ap.add_argument("--only", choices=["parity", "wkv_parity"],
                    default=None,
                    help="run the device and build phases and this one, "
                    "then end")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (args.src / "repro_torch").is_dir():
        print(f"chip_smoke: {args.src / 'repro_torch'} not found",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": kind, "nvidia_smi": smi,
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count(), "tf32": False})

    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import paged as kpaged

    info = cuda_lib.build()
    # each kernel's entry line, then its spills and registers
    ptxas = [ln.strip() for ln in info.log.splitlines()
             if "entry function" in ln or "registers" in ln
             or "spill" in ln]
    emit({"phase": "build", "seconds": info.seconds, "cached": info.cached,
          "library": info.path.name, "ptxas": ptxas})

    if args.only is not None:
        if args.only == "parity":
            phase_parity(torch, kpaged, check_grids=(
                args.src.resolve() == SRC.resolve()))
        else:
            phase_wkv_parity(torch)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                     "count": torch.cuda.device_count()}})
        return 0
    t_phase = {}
    t0 = time.perf_counter()
    results, timings = phase_parity(torch, kpaged)
    flash_results, flash_timings = phase_flash_parity(torch)
    results.update(flash_results)
    timings.update(flash_timings)
    t_phase["parity"] = time.perf_counter() - t0
    launches = {}
    t0 = time.perf_counter()
    for arch in ("smollm-135m@inhibitor", "smollm-135m"):
        kernel, n, _ = phase_serve(torch, kops, arch)
        launches[kernel] = n
    phase_decode_paths(torch)
    t_phase["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for arch in ("smollm-135m@inhibitor", "smollm-135m"):
        kernel, n, _ = phase_train(torch, kops, arch)
        launches[kernel] = n
    phase_train_xcheck(torch, kops)
    t_phase["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    results["wkv6"], timings["wkv6"] = phase_wkv_parity(torch)
    t_phase["wkv_parity"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches["wkv6"], _ = phase_rwkv_train(torch, kops)
    phase_rwkv_xcheck(torch, kops)
    forward_launches, _ = phase_rwkv_forward(torch, kops)
    t_phase["rwkv"] = time.perf_counter() - t0

    sources = {"paged": "src/repro_torch/csrc/paged_decode.cu",
               "flash": "src/repro_torch/csrc/flash_prefill.cu",
               "wkv6": "src/repro_torch/csrc/wkv6.cu"}
    replaces = {"paged_inhibitor":
                "src/repro/kernels/paged.py:124 _paged_inhibitor_kernel",
                "paged_attention":
                "src/repro/kernels/paged.py:259 _paged_attention_kernel",
                "flash_inhibitor":
                "src/repro/kernels/inhibitor.py:99 _flash_inhibitor_kernel",
                "flash_attention":
                "src/repro/kernels/flash.py:35 _flash_attention_kernel",
                "wkv6": "src/repro/kernels/rwkv6.py:43 _wkv6_kernel"}
    kernels = []
    for name in replaces:
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": sources[name.split("_")[0]],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": results[name]["max_abs_err"],
            "tol": results[name]["tol"], "ms": t["ms"],
            "kernel_ms": t["ms"], "device_us": t.get("device_us"),
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    # the WKV kernel's other main path: the full-depth eval forward
    kernels[-1]["launches_full_depth_forward"] = forward_launches
    kernels[-1].update(forward_ms=timings["wkv6"]["forward_ms"],
                       forward_device_us=timings["wkv6"]["forward_device_us"],
                       forward_bound_ms=timings["wkv6"]["forward_bound_ms"])
    check(all(math.isfinite(k["ms"]) for k in kernels), "bad kernel timing")
    emit({"phase_seconds": t_phase})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
