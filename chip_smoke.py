#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

  1. device  — require CUDA; print the card's name and power limit.
  2. build   — compile the CUDA kernels (csrc/paged_decode.cu) from the
               checkout.
  3. parity  — each paged decode kernel against its plain PyTorch version
               on the card, at smollm-135m's decode shapes (h=9, h_kv=3,
               d=64, page 16, batch 8, table width 32, ragged lengths 1..512,
               two rows sharing pages, a poisoned trash page, a window
               case), with kernel, plain, library and bound times.
  4. serve   — smollm-135m@inhibitor, then smollm-135m (dot-product), at
               full width (bf16 compute, seeded random init) through the
               paged engine: 8 requests, 128-token prompts, 32 new tokens.
               Each arm's launch counts are zeroed just before it is
               driven and read just after: its kernel must launch decode
               ticks x 30 times and its plain version never.
  5. decode_paths — one full-width paged decode step through the kernel
               and through the forced gather backend; logits must agree.

Then the ``kernels`` summary line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.  TF32 is off for matmuls and cuDNN.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and
# float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations per (query head, attendable key, head dim) element:
# inhibitor |q-k| (sub, abs, add) + combine (select, add/sub, clamp,
# accumulate); Softmax two FMAs (q.k and p.v)
OPS_PER_ELEMENT = {"paged_inhibitor": 7, "paged_attention": 4}

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


def make_pools(gen, dtype, layers: int = 1, poison: bool = True,
               qk_std: float = 1.0, device: str = "cuda"):
    """Ragged paged pools in the engine's layout: per-row non-contiguous
    pages, trash page 0 for unmapped entries, rows 5/6 sharing their first
    pages; q and k of stddev ``qk_std``, v unit normal.  With ``poison``,
    the trash page and every row's tail past its cursor hold ±1e9.
    Returns q, k_pool, v_pool, tables, lengths."""
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
    q = (torch.randn((BATCH, 1, H, D), generator=gen, device=device)
         * qk_std).to(dtype)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=device)
    return q, kp, vp, tables.to(device), lengths


def bound(name: str, q, tables, lengths, window, elem: int) -> dict:
    """Least time for the work these inputs need: K and V of each distinct
    (page, slot) position some row attends read once (rows sharing pages
    read them once between them), q read and out written once, the table
    entries walked and the lengths read once; the kernel's float32
    operations on the attendable keys of every query head."""
    positions, entries, ops = set(), 0, 0
    tab = tables.tolist()
    for row, ln in enumerate(lengths.tolist()):
        lo = max(0, ln - window) if window is not None else 0
        positions.update((tab[row][j // PS], j % PS) for j in range(lo, ln))
        entries += -(-ln // PS) - lo // PS
        ops += (ln - lo) * H * D * OPS_PER_ELEMENT[name]
    nbytes = (2 * len(positions) * H_KV * D * elem + 2 * q.numel() * elem
              + 4 * entries + 4 * lengths.numel())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
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
        for name, kw, window in cases:
            fwd, plain = kernel_fns(kpaged, name)
            q, kp, vp, tables, lengths = pools[name]
            out = fwd(q, kp[0], vp[0], tables, lengths, window=window, **kw)
            ref = plain(q, kp[0], vp[0], tables, lengths, window=window, **kw)
            control = plain(q, kp[0], vp[0].roll(1, dims=0), tables, lengths,
                            window=window, **kw)
            label = f"{name} {kw} window={window} {dtype}"
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
        for name in QK_STD:
            fwd, _ = kernel_fns(kpaged, name)
            q, kp, vp, tables, lengths = pools[name]
            clean = fwd(q, kp[0], vp[0], tables, lengths)
            kn, vn = kp[0].clone(), vp[0].clone()
            for t in (kn, vn):
                t[0] = float("nan")
                for row, ln in enumerate(LENGTHS):
                    if ln % PS:
                        t[int(tables[row, ln // PS]), ln % PS:] = float("nan")
            check(torch.equal(fwd(q, kn, vn, tables, lengths), clean),
                  f"{name} kernel read a masked position (nan poison)")
    return results


def phase_parity(torch, kpaged):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)
    results = parity_checks(torch, kpaged)

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
        t = {"ms": cuda_ms(lambda i: fwd(q, kp[i % LAYERS], vp[i % LAYERS],
                                         tables, lengths), n),
             "plain_ms": cuda_ms(lambda i: plain(
                 q, kp[i % LAYERS], vp[i % LAYERS], tables, lengths), 30)}
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


def phase_serve(torch, kpaged, arch: str):
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
    kpaged.reset_counts()
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
    counts = kpaged.counts()
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
    check(counts[kernel + "_plain"] == 0 and counts[other] == 0
          and counts[other + "_plain"] == 0,
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
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
    from repro_torch.kernels import paged as kpaged

    info = cuda_lib.build()
    ptxas = [ln.strip() for ln in info.log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": info.seconds, "cached": info.cached,
          "library": info.path.name, "ptxas": ptxas})

    results, timings = phase_parity(torch, kpaged)
    launches = {}
    for arch in ("smollm-135m@inhibitor", "smollm-135m"):
        kernel, n, _ = phase_serve(torch, kpaged, arch)
        launches[kernel] = n
    phase_decode_paths(torch)

    source = "src/repro_torch/csrc/paged_decode.cu"
    replaces = {"paged_inhibitor":
                "src/repro/kernels/paged.py:124 _paged_inhibitor_kernel",
                "paged_attention":
                "src/repro/kernels/paged.py:259 _paged_attention_kernel"}
    kernels = []
    for name in ("paged_inhibitor", "paged_attention"):
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": results[name]["max_abs_err"],
            "tol": results[name]["tol"], "ms": t["ms"],
            "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    check(all(math.isfinite(k["ms"]) for k in kernels), "bad kernel timing")
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
