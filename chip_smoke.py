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
               kv head and at the served families' shapes (signed and
               unsigned inhibitor, Softmax): d 128 at group 1 (16 / 16
               heads), group 4 (32 / 8) and group 5 (40 / 8), d 64 at
               group 5 with a
               1,024-key window over cursors up to 1,100; with kernel,
               plain, library and bound times, the kernel's and the
               library's device time per call (CUDA kernels in a
               torch.profiler trace, no host time) and each split
               kernel's launch grid (splits and blocks) read from that
               trace; then both kernels timed the same way at
               qwen2-moe-a2.7b's decode shape (batch 8, 16 / 16 heads, d
               128, cursors 1..512) and hymba-1.5b's (batch 4, 25 / 5, d
               64, window 1,024, table width 128) and
               llava-next-mistral-7b's (batch 8, 32 / 8, d 128).
  4. serve   — smollm-135m@inhibitor, then smollm-135m (dot-product), at
               full width (bf16 compute, seeded random init) through the
               paged engine (max_batch 8, max_len 512, page 16, prefix
               cache on, warm-up "serve": every proven decode and prefill
               bucket tuned and captured as a CUDA graph at construction):
               8 requests, 128-token prompts, 32 new tokens.  Each arm's
               launch counts are zeroed just before it is driven and read
               just after: its kernel must launch decode ticks x 30 times
               (= replays x captured: every tick is a graph replay, no
               step is built while serving) and its plain version never;
               the steps built stay within the proven retrace budget
               (6 decode, 6 prefill buckets); every decode bucket's paged
               choice is "timed"; the greedy tokens equal the same
               engine's steps run eagerly, never captured.  Printed: tick
               p50, ITL, TTFT, tok/s, and one decode-only tick's device
               µs and idle share from a torch.profiler range.  Then the
               serve launcher with --trace-out and --log-json (4 requests,
               inhibitor arm): its trace must validate.
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
               call at the train shapes; then both kernels at the shapes
               phases 20-22 run (``FLASH_FAMILY_SHAPES``: non-causal b 2
               x 4,096 and b 4 x 1,024 at group 1 and d 64, causal b 2 x
               1,024, causal b 1 x 3,008 and b 2 x 3,136 at group 4 and d
               128), one launch a call, held in
               bf16 and float32, timed in bf16 beside SDPA, with the
               query tile each takes and the d 128 instantiations'
               ptxas registers.  Then the inhibitor's backward kernel
               (``flash_inhibitor_bwd``: dq, dk, dv) against its plain
               version, the analytic VJP on float32 copies, with q and k
               free (plus the tie allowance) and on a 2^-6 grid
               (FLASH_BWD_TOL), at the train phase's shape
               in bf16 and at the inhibitor's other cases' shapes in
               both dtypes, two calls bit-equal; its ms and device µs a
               call at the train shape beside its bound (9 instructions
               an element, ``flash_bound``) and the plain version's ms.
 6a. query_split — the two flash kernels through their training entries
               (``kernels.ops.flash_inhibitor`` / ``flash_attention``) on
               M query slices of one attention, each at its ``q_offset``
               over every key, one after the other as M ``model`` ranks
               would under sequence parallelism: smollm-135m (9 / 3 heads
               of 64, b 8 x 1,024, causal, M 4, both mechanisms) and
               hymba-1.5b (25 / 5 of 64, b 1 x 4,096, window 1,024, M 16:
               the Softmax, and the inhibitor's forward), bf16.  The
               slices' outputs concatenated against the whole call
               (offset 0, expected bit-equal) and the plain version, the
               slices at offset 0 outside the tolerance; the backward (in
               float32) dq concatenated and dk, dv summed over the slices
               against the whole backward;
               one launch a slice, no plain call; each slice's device µs
               from one trace beside its bound.
  7. train   — smollm-135m@inhibitor, then smollm-135m, at full width and
               depth (float32 parameters, bf16 compute, remat "full"),
               through ``repro_torch.train.loop.train`` (the loop the
               training launcher runs) with the launcher's optimizer,
               fitting one batch 8 x seq 1024 of the seeded LM stream.
               The planner must pick ``pallas`` on its own; the arm's
               flash kernel must launch steps x 30 x 2 times (forward and
               remat recompute), the inhibitor's backward kernel steps x
               30 times, their plain versions never; every loss finite
               and the last below the first by TRAIN_MIN_FALL.
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
 13. lanes   — the integer and TFHE-simulated lanes of paper-tiny at full
               width (seeded init, wq and wk scaled by 1/sqrt(head_dim)),
               which run none of the five kernels (every count stays 0):
               (a) ``lm_forward_lane`` on the int lane on the card at seq 8
               and 512 for inhibitor, inhibitor_unsigned and dotprod,
               bit-exact with the same call on the CPU, at least 10% of
               the logits non-zero, a control with every wv negated
               different; (b) the fhe_sim lane on the card at seq 8 and
               128, bit-exact with (a)'s int lane, its scope report equal
               to the CPU run's, cmuls 0 on both inhibitor arms and above
               0 on dotprod, the TFHE parameters it selects printed; (c)
               the planner's ``int`` backend at smollm-135m's attention
               widths (9 / 3 heads, d 64, b 1, n 256, causal, int32 q, k,
               v on the card): planned on its own, bit-exact with the CPU;
               the ``fhe_sim`` backend forced without a mask at n 32,
               bit-exact with the int lane at the same shifts; (d)
               printed: the walls of (a) and (b), the paper's Table 3
               protocol (each arm's int32 entry point at T 32..256, one
               head, d 16, 20 calls after warm-up), and the largest
               max|a|·max|b|·K ``exact_int_matmul`` checked, against 2^53.
 14. analysis — the static FHE circuit analyzer (interval lane, on the
               host) on paper-tiny at its full config, PTQ'd from phase
               13's parameters, for inhibitor, inhibitor_unsigned and
               dotprod at seq 8 and 128, against the fhe_sim forward on
               the card for three token seeds and all-zero tokens: per-
               scope counts equal, widths dominated, the cross-checked
               parameter selection passing, the static msg_bits no
               smaller; zero cmuls proven (and measured) on both inhibitor
               arms, cmul sites exactly at L0.attn on dotprod; LUTs
               verified; a static report lowered by one bit at its worst
               scope refused as unsound; no kernel launched.  Then the
               CLI (``python -m repro_torch.analysis``) writes
               build/ANALYSIS_fhe.json and exits 0.  Printed: the
               analysis wall per arm and seq, the measured walls.
 15. resume — checkpoint and resume through the training loop:
               smollm-135m at full width and depth, then
               smollm-135m@inhibitor at depth 2, b 8 x 1024 of the seeded
               LM stream: two uninterrupted 8-step runs, a run cut at
               step 6 (async commits every 4 steps) and a rerun resumed
               from its step-6 commit to 8, whose parameters and
               optimizer state must equal the uninterrupted run's within
               rtol 1e-5 / atol 1e-6, as must the two uninterrupted runs
               (both measures printed); the arm's flash kernel launched
               steps x layers x 2 times.
               Then remat "dots" against "full" gradients at depth 2 for
               both arms (within REMAT_TOL), each one's walls and peak
               memory.  Printed: save and restore seconds, checkpoint
               bytes.
 16. serve_rwkv — rwkv6-7b at full width and depth (32 layers, phase
               12's last-seed parameters) served through the engine:
               contiguous slots, max_batch 4, max_len 256, warm-up
               "decode" (its one decode step captured at construction); 4
               requests of 64 random prompt tokens, 16 new tokens each.
               Counts zeroed just before, read just after: no kernel
               launched and no plain chunked WKV call (the exact scan, as
               the reference); every decode tick a replay; the steps
               within the proven budget (which marks the family
               unbucketed); the greedy tokens equal to the same engine's
               with graphs off and to each request alone through an eager
               ``lm_step`` loop (first-token logits within 5% of the
               largest); a second wave whose first request repeats the
               first prompt in the recycled slot 0 reproduces its tokens.
               Printed beside the card's name and power limit: tick p50,
               ITL, TTFT, tok/s, a second-wave tick's device time and
               idle share, the tick's floor (every weight read once) and
               peak memory.
 17. serve_analysis — the static serve analyzer on the host:
               ``analyze_serve`` for smollm-135m at phase 4's geometry
               (both allocators proven, signatures verified, 0 host syncs
               in the steps), the reduced rwkv6-7b rejected (prefill
               proven > declared), ``cross_check_bench`` over phases 4
               and 16's live engines; for information, the decode tick's
               static ``est_s`` beside phase 4's device time, and the
               launch overhead behind the cost model's ``dispatch_s``.
 18. serve_moe — qwen2-moe-a2.7b@inhibitor, then qwen2-moe-a2.7b, at full
               width and depth (24 layers, 64 experts of 1408 top 4 and
               a gated shared expert; 15.15 B float32 parameters drawn on
               the card from a CUDA generator, bf16 compute; the
               inhibitor arm's wq and wk scaled by 1/sqrt(128)) through
               phase 4's engine and traffic (paged, max_batch 8,
               max_len 512, page 16, prefix cache on, warm-up "serve"; 8
               requests of 128 random tokens, 32 new each).  Counts
               zeroed just before, read just after: the arm's kernel
               launched decode ticks x 24 times, every other count 0;
               every tick a replay; the steps within the proven budget;
               every decode bucket's paged choice timed; the greedy
               tokens equal to the same engine's steps run eagerly over
               the same batches (MoE capacity ties a batch's rows
               together); one full-width decode step through the kernel
               within 5% of the forced gather backend's largest logit, a
               V-zeroed control outside, at least 10% of layer 0's
               inhibitor outputs non-zero; peak memory under the card's.
               Printed beside the card's name and power limit: tick p50,
               ITL, TTFT, tok/s, a second wave's profiled tick (device
               time, idle share), the tick's floor (every weight read
               once), peak memory and the MoE dropped fraction of the
               eager run.  Each arm's parameters are freed after it.
 19. serve_hybrid — hymba-1.5b@inhibitor, then hymba-1.5b (32 layers,
               attention with a 1,024-key window beside a Mamba branch),
               the same way: paged, max_batch 4, max_len 2048, page 16,
               prefill chunk 32, the prefix cache refused by the family,
               warm-up "decode"; 4 requests (one of 1,100 tokens, whose
               decode reads past the window, and three of 64), 16 new
               each; launches = ticks x 32; tokens equal to the eager
               engine's; a second wave whose first request repeats the
               1,100-token prompt in the recycled slot 0 reproduces its
               tokens; the KV pools, cursors, tables and the ssm / conv
               carries keep their storage across the waves; the decode
               step kernel against gather with the window biting.  The
               first request's TTFT (35 eager chunks through the Mamba
               loop) is printed on its own.
 20. serve_vlm — llava-next-mistral-7b@inhibitor, then
               llava-next-mistral-7b (32 layers, d 4,096, 32 / 8 heads of
               128, d_ff 14,336, vocab 32,000, ``frontend_proj``: 7.25 B
               float32 parameters drawn on the card), through phase 18's
               engine, traffic and checks (launches = ticks x 32).  Then
               the image prefill: ``api.forward`` on b 1 x (2,880 patch
               embeddings + 128 tokens) at full depth in bf16, every
               layer planned ``pallas`` and its flash kernel launched
               once; wall, device time, the kernel's µs a call beside
               its bound and SDPA's; at depth 4 in float32 the kernel
               forward within FORWARD_REL of the plain path (``blocked``
               / ``fused`` forced), a V-shifted control outside.
 21. encdec — seamless-m4t-large-v2@inhibitor, then
               seamless-m4t-large-v2 (24 + 24 layers, d 1,024, 16 / 16
               heads of 64, d_ff 8,192, vocab 256,206: 1.63 B
               parameters): ``encode`` of b 2 x 4,096 frames (every
               layer ``pallas``, non-causal), ``decode_train`` over 1,024
               tokens (self-attention ``pallas``, causal;
               cross-attention ``chunked`` / ``fused``), 64 greedy
               ``decode_step`` calls on a contiguous cache (no kernel);
               at depth 4 in float32 the encoder against the plain path
               and the steps against teacher forcing (STEP_REL); walls,
               device times, the step against its floor, peak memory.
 22. train_families — reduced float32 gradients on the card against the
               CPU port's (GRAD_REL) for every family below; then AdamW
               steps on one fixed batch each: qwen2-moe-a2.7b (depth 2,
               b 4 x 512), hymba-1.5b (depth 4, b 4 x 256),
               seamless-m4t-large-v2 (whole, b 4 x 1,024 frames x 512
               tokens; @inhibitor at depth 2), llava-next-mistral-7b
               (depth 2, b 2 x (2,880 image + 256 text)): launches =
               steps x kernel sites x 2, losses finite and falling by
               TRAIN_FAMILY_MIN_FALL; step wall, positions a second,
               peak memory.
 23. distributed — on a one-rank NCCL process group (the card is one
               GPU; multi-rank behaviour is held on the CPU over gloo) and
               a (1, 1) ("data", "model") mesh: smollm-135m at full width
               and depth, then @inhibitor at depth 2, DIST_STEPS AdamW
               steps of one batch TRAIN_B x TRAIN_N (remat "full")
               through the sharded train step (DTensor parameters and
               moments; the tensor-parallel path: every attention, MLP
               and the tied embedding handed split over the size-1
               ``model`` axis, the vocab-parallel NLL) against the
               unsharded ``make_train_step`` from the same parameters:
               losses and every parameter within DIST_REL, a perturbed
               shard outside, the arm's flash kernel launched steps x
               layers x 2 times and its plain version never; the layers
               handed split, the measured differences, the wall ratio,
               step walls, device times, peak memory.  The same for the
               RWKV-6 and Mamba mixers split over ``model``
               (DIST_MIXER_ARMS): rwkv6-7b at full width, depth 2, b 8 x
               1,024, its time-mix and channel-mix handed split and
               ``wkv6`` launched steps x layers x 2 times (on the
               time-mix's heads); hymba-1.5b at full width, depth 2,
               b 4 x 256, its attention, Mamba branch and MLP handed
               split (no kernel at 256 positions).
               Then ``compress_tree`` / ``decompress_tree`` on the
               full-width gradient tree bit-equal to the CPU port (each
               residual within scale / 2); ``compressed_grad_sync``,
               ``allgather_matmul`` and ``pipeline_apply`` on one-rank
               meshes (the sends go to the rank itself) against the card's
               own products and, within GRAD_REL, the CPU's;
               ``train()`` under the mesh with checkpoints, both arms at
               the same depths: 8 steps of ``lm_batch_at(seed 0, step)``
               with async commits every 4 (keep 2), then the same run
               cut at 6 and resumed to 8: losses, parameters and moments
               equal (0.0), the resumed leaves DTensors with the fresh
               placements, the last commit restored without a mesh onto
               the card equal to the gathered state, the card's memory
               during a save at most one leaf above its level before;
               commit bytes, write and read seconds; then qwen2-moe-a2.7b
               at depth 2, b 4 x 1024, 4 microbatches (each 1 x 1024,
               through ``flash_attention``), 2 AdamW steps sharded and
               then unsharded (``make_train_step(..., microbatches=4)``),
               the card freed between them: losses and parameters within
               DIST_MOE_REL, launches steps x 4 x 2 x 2 in each run,
               every MoE call of the sharded run on split experts, the
               dropped fraction printed (at one batch rank the global
               re-split is the identity; multi-rank microbatches are held
               on the CPU over gloo);
               the process group is destroyed; then the dry-run CLI for
               smollm-135m decode_32k --multi-pod in a subprocess (host
               only): rc 0, "[OK]", its record printed with its per-rank
               FLOPs and its all-reduce count.

Then the ``kernels`` summary line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.  TF32 is off for matmuls and cuDNN.

    python3 chip_smoke.py --only parity [--src OTHER/src]
    python3 chip_smoke.py --only wkv_parity [--src OTHER/src]
    python3 chip_smoke.py --only lanes
    python3 chip_smoke.py --only serve [--src OTHER/src]
    python3 chip_smoke.py --only analysis
    python3 chip_smoke.py --only resume
    python3 chip_smoke.py --only serve_rwkv
    python3 chip_smoke.py --only serve_analysis
    python3 chip_smoke.py --only serve_moe
    python3 chip_smoke.py --only serve_hybrid
    python3 chip_smoke.py --only serve_vlm
    python3 chip_smoke.py --only encdec
    python3 chip_smoke.py --only train_families
    python3 chip_smoke.py --only flash_parity
    python3 chip_smoke.py --only query_split
    python3 chip_smoke.py --only distributed

run phases 1, 2 and 3 (or 9, or 13, or 4, or 14, or 15, or 16, or 4
and 17, or 18, or 19, or 20, or 21, or 22, or 6, or 23) alone, against the
package under
``--src`` (by default this checkout's): another commit's kernels checked
and timed by this script's phase.  Against another package, phase 3 records the
launch grids without holding them to the split design, and phase 4
serves that package's engine as it is (another commit's eager ticks,
say) and takes only its walls and its profiled tick.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

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
# The inhibitor's backward (dq, dk, dv): 9 instructions, the least that
# compute it: 2 for the score, 3 for the dv indicator and the pair's sum
# of sigma g [|v| > Z] (a compare, a predicated add, a predicated fma),
# 4 for sign(q - k) t into dq and dk (two compares, two predicated adds
# of +-t); its kernel recomputes the score and the pair's sum in a second
# pass (17).
OPS_PER_ELEMENT = {"paged_inhibitor": 4, "paged_attention": 4,
                   "flash_inhibitor": 4, "flash_attention": 4,
                   "flash_inhibitor_bwd": 9}
# each training kernel's backward kernel, where it has one: a train step
# launches it once a kernel site, the forward kernel twice (remat "full"
# and "dots" recompute the forward)
BACKWARD_KERNEL = {"flash_inhibitor": "flash_inhibitor_bwd"}

H, H_KV, D, PS, BATCH, WIDTH = 9, 3, 64, 16, 8, 32
LENGTHS = [1, 15, 16, 17, 100, 300, 511, 512]
SHARED_ROWS, SHARED_PAGES = (5, 6), 10     # rows 5 and 6 share 160 tokens
LAYERS = 30                                # pools cycled when timing
WINDOW = 64


def train_launches_ok(counts: dict, kernel: str, launches: int) -> bool:
    """A training run's counts: ``kernel`` launched ``launches`` times, its
    backward kernel (if any) half as often, every other kernel and every
    plain version never."""
    want = {kernel: launches}
    if kernel in BACKWARD_KERNEL:
        want[BACKWARD_KERNEL[kernel]] = launches // 2
    return all(n == want.get(name, 0) for name, n in counts.items())


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


def traced_records(run, pad: int, label: str):
    """The device records of ``run()`` in a torch.profiler trace: ``run``
    goes inside a recorded range after ``pad`` tiny fills, and only the
    records whose correlation ids match a runtime call made inside that
    range count (a graph replay's kernels carry its launch's id).  Returns
    (records, the range's (start, end) in µs, the runtime calls that left
    no record)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    fill = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(pad):
            fill.zero_()
        torch.cuda.synchronize()
        with record_function(label):
            run()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    span = [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("name") == label and e.get("cat") == "user_annotation"]
    check(len(span) == 1, f"{len(span)} {label} ranges in the trace")
    lo, hi = span[0]
    calls = {e["args"]["correlation"] for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})
             and lo <= e["ts"] <= hi
             and any(w in e.get("name", "") for w in DEVICE_WORK_CALLS)}
    records = [e for e in events if e.get("cat") in DEVICE_RECORDS
               and e.get("args", {}).get("correlation") in calls]
    lost = calls - {e["args"]["correlation"] for e in records}
    return records, (lo, hi), len(lost)


def device_us(fn, n: int, grids: bool = False, attempts: int = 3,
              warm: int = 3, names: tuple = ()) -> dict:
    """Device time per call of fn(i) without the host: the device records
    (kernels, copies, fills) of n calls (after ``warm`` untraced ones) in
    a torch.profiler trace, summed and divided by n, with the records per
    call, the mean per record, with ``names`` the time and launches per
    call of the kernels whose name holds one of them, and with ``grids``
    each kernel's launch grids as the trace recorded them.

    The n calls run inside one ``traced_records`` range.  On the H100 the
    trace drops the first records of a session, more the longer the
    process has run (a handful after a few minutes), so the range follows
    ``pad`` tiny fills; a trace in which any call of the range lost its
    record is taken again with four times the pad, and after ``attempts``
    such traces the phase fails."""
    import torch

    for i in range(warm):
        fn(i)
    torch.cuda.synchronize()
    pad = 1000
    for attempt in range(1, attempts + 1):
        records, _, lost = traced_records(
            lambda: [fn(i) for i in range(n)], pad, "device_us")
        if records and lost == 0:
            break
        check(attempt < attempts, f"the profiler trace lost {lost} device "
              f"records of the timed calls in each of {attempts} traces "
              f"(last pad {pad} fills)")
        pad *= 4
    total = sum(float(e["dur"]) for e in records)
    out = {"us": total / n, "kernels_per_call": len(records) / n,
           "us_per_launch": total / len(records), "trace_attempts": attempt}
    if names:
        hit = [e for e in records if e["cat"] == "kernel"
               and any(m in e["name"] for m in names)]
        out["named_us"] = sum(float(e["dur"]) for e in hit) / n
        out["named_launches"] = len(hit) / n
    if grids:
        out["grids"] = {}
        for e in records:
            if e["cat"] == "kernel" and "grid" in e["args"]:
                seen = out["grids"].setdefault(e["name"], [])
                if e["args"]["grid"] not in seen:
                    seen.append(e["args"]["grid"])
    return out


@dataclasses.dataclass(frozen=True)
class PagedShape:
    """A paged decode shape: query / kv heads, head_dim, batch, table
    width in pages, the rows' cursors, two rows sharing their first
    pages, and the attention window."""
    heads: int = H
    kv_heads: int = H_KV
    d: int = D
    batch: int = BATCH
    width: int = WIDTH
    lengths: tuple = tuple(LENGTHS)
    shared_rows: Optional[tuple] = SHARED_ROWS
    window: Optional[int] = None

    @property
    def qk_std(self) -> dict:
        return {"paged_inhibitor": self.d ** -0.5, "paged_attention": 1.0}


#: smollm-135m's decode shape (phase 4)
SMOLLM_SHAPE = PagedShape()


def make_pools(gen, dtype, layers: int = 1, poison: bool = True,
               qk_std: float = 1.0, device: str = "cuda",
               heads: Optional[int] = None,
               shape: PagedShape = SMOLLM_SHAPE):
    """Ragged paged pools in the engine's layout at ``shape``: per-row
    non-contiguous pages, trash page 0 for unmapped entries, the shared
    rows sharing their first pages; q (``heads`` query heads, default the
    shape's) and k of stddev ``qk_std``, v unit normal.  With ``poison``,
    the trash page and every row's tail past its cursor hold ±1e9.
    Returns q, k_pool, v_pool, tables, lengths."""
    import torch

    num_pages = shape.batch * shape.width + 1
    pool = (layers, num_pages, PS, shape.kv_heads, shape.d)
    kp = (torch.randn(pool, generator=gen, device=device) * qk_std).to(dtype)
    vp = torch.randn(pool, generator=gen, device=device).to(dtype)
    perm = (torch.randperm(num_pages - 1, generator=gen, device=device)
            + 1).tolist()
    tables = torch.zeros((shape.batch, shape.width), dtype=torch.int32)
    nxt = 0
    for row, ln in enumerate(shape.lengths):
        used = -(-ln // PS)
        tables[row, :used] = torch.tensor(perm[nxt:nxt + used])
        nxt += used
    if shape.shared_rows is not None:
        a, b = shape.shared_rows
        tables[b, :SHARED_PAGES] = tables[a, :SHARED_PAGES]
    if poison:
        kp[:, 0], vp[:, 0] = 1e9, -1e9
    for row, ln in enumerate(shape.lengths):
        tail = ln % PS
        if tail and poison:
            page = int(tables[row, ln // PS])
            kp[:, page, tail:], vp[:, page, tail:] = 1e9, -1e9
    q = (torch.randn((shape.batch, 1, heads or shape.heads, shape.d),
                     generator=gen, device=device) * qk_std).to(dtype)
    lengths = torch.tensor(shape.lengths, dtype=torch.int32, device=device)
    return q, kp, vp, tables.to(device), lengths


def bound(name: str, q, tables, lengths, window, elem: int,
          shape: PagedShape = SMOLLM_SHAPE) -> dict:
    """Least time for the work these inputs need: K and V of each distinct
    (page, slot) position some row attends read once (rows sharing pages
    read them once between them), q read and out written once, the table
    entries walked and the lengths read once; the kernel's float32
    operations on the attendable keys of every query head (the
    inhibitor's as instructions, with the sum of v per kv head)."""
    positions, entries, ops = set(), 0, 0
    h, h_kv, d = shape.heads, shape.kv_heads, shape.d
    tab = tables.tolist()
    for row, ln in enumerate(lengths.tolist()):
        lo = max(0, ln - window) if window is not None else 0
        positions.update((tab[row][j // PS], j % PS) for j in range(lo, ln))
        entries += -(-ln // PS) - lo // PS
        ops += (ln - lo) * h * d * OPS_PER_ELEMENT[name]
        if name == "paged_inhibitor":
            ops += (ln - lo) * h_kv * d + h * d
    nbytes = (2 * len(positions) * h_kv * d * elem + 2 * q.numel() * elem
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
# the cursors of the long-context shape: around hymba-1.5b's 1,024-key
# window and past it, to phase 19's 1,100-token prompt (rows 5 and 6
# share their first pages)
LONG_LENGTHS = (1, 17, 300, 1023, 1024, 1025, 1100, 1100)
# the served families' shapes, each held (signed and unsigned inhibitor,
# Softmax; bf16 and float32) against the plain versions: d 128 at group
# 1 (qwen2-moe-a2.7b, qwen1.5-4b: 16 / 16 heads), group 4
# (llava-next-mistral-7b: 32 / 8) and group 5 (llama4-scout: 40 / 8), d
# 64 at group 5 with hymba-1.5b's window of 1,024 keys over cursors up
# to 1,100
FAMILY_SHAPES = {
    "d128 group 1": PagedShape(heads=16, kv_heads=16, d=128),
    "d128 group 4": PagedShape(heads=32, kv_heads=8, d=128),
    "d128 group 5": PagedShape(heads=40, kv_heads=8, d=128),
    "d64 group 5 window 1024": PagedShape(heads=25, kv_heads=5, d=64,
                                          width=128, lengths=LONG_LENGTHS,
                                          window=1024),
}
# the decode shapes phases 18, 19 and 20 serve, at which both kernels
# are timed: qwen2-moe-a2.7b's (batch 8, cursors 1..512 as phase 4's, 24
# layers' pools cycled), hymba-1.5b's (batch 4 at its table-width bucket
# 128: the 1,100-token prompt's row after its 16 new tokens and three
# 64-token rows after theirs, 32 layers' pools) and
# llava-next-mistral-7b's (phase 4's batch and cursors, 32 layers)
SERVE_SHAPES = {
    "qwen2-moe-a2.7b": (PagedShape(heads=16, kv_heads=16, d=128), 24),
    "llava-next-mistral-7b": (PagedShape(heads=32, kv_heads=8, d=128), 32),
    "hymba-1.5b": (PagedShape(heads=25, kv_heads=5, d=64, batch=4,
                              width=128, lengths=(1116, 80, 80, 80),
                              shared_rows=None, window=1024), 32),
}


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
        # the served families' shapes
        for shape_name, shape in FAMILY_SHAPES.items():
            for kernel, kws in (("paged_inhibitor", (dict(signed=True),
                                                     dict(signed=False))),
                                ("paged_attention", ({},))):
                name = f"{kernel} {shape_name}"
                pools[name] = make_pools(gen, dtype, shape=shape,
                                         qk_std=shape.qk_std[kernel],
                                         device=device)
                cases += [(name, kw, shape.window) for kw in kws]
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
                # sums of up to max(lengths) terms of size |V| + Z ~ 3:
                # its own rounding grows with the key count
                tol *= max(lengths.tolist()) / 8
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
            r.setdefault("shapes", set()).add(
                label_name.partition(" ")[2] or "smollm-135m")
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
                for row, ln in enumerate(lengths.tolist()):
                    if ln % PS:
                        t[int(tables[row, ln // PS]), ln % PS:] = float("nan")
            check(torch.equal(fwd(q, kn, vn, tables, lengths), clean),
                  f"{label_name} kernel read a masked position (nan poison)")
    for name in ("paged_inhibitor", "paged_attention"):
        results[name]["groups"] = [H // H_KV, *SPLIT_GROUPS]
        results[name]["shapes"] = sorted(results[name]["shapes"])
    return results


def phase_parity(torch, kpaged, check_grids: bool = True):
    """parity_checks, then each kernel timed at the main path's shapes.
    With ``check_grids``, each split kernel's launch grid in the trace
    must be (batch x kv heads, ceil(width / pages per split)) over more
    blocks than the card has SMs; without, the grids are only recorded
    (another commit's kernels)."""
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
            library = sdpa_library(torch, q, kp, vp, tables, lengths,
                                   SMOLLM_SHAPE, LAYERS)
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
    timings["serve_shapes"] = serve_shape_timings(torch, kpaged, gen, n)
    emit({"phase": "parity", "shapes": {
        "heads": H, "kv_heads": H_KV, "head_dim": D, "page_size": PS,
        "batch": BATCH, "table_width": WIDTH, "lengths": LENGTHS,
        "shared_rows": SHARED_ROWS, "window": WINDOW},
        "family_shapes": {k: dataclasses.asdict(v)
                          for k, v in FAMILY_SHAPES.items()},
        "results": results, "timings": timings})
    return results, timings


def sdpa_library(torch, q, kp, vp, tables, lengths, shape: PagedShape,
                 layers: int):
    """The library yardstick of the paged Softmax kernel: call i gathers
    layer i's pages by the tables and runs ``scaled_dot_product_attention``
    under a bool mask of each row's cursor (and window)."""
    import torch.nn.functional as F

    group = shape.heads // shape.kv_heads
    j = torch.arange(shape.width * PS, device="cuda")[None]
    mask = j < lengths.long()[:, None]
    if shape.window is not None:
        mask &= j >= lengths.long()[:, None] - shape.window
    mask = mask[:, None, None, :]
    idx = tables.long()

    def library(i):
        k = kp[i % layers][idx].reshape(shape.batch, -1, shape.kv_heads,
                                        shape.d)
        v = vp[i % layers][idx].reshape(shape.batch, -1, shape.kv_heads,
                                        shape.d)
        k = k.transpose(1, 2).repeat_interleave(group, dim=1)
        v = v.transpose(1, 2).repeat_interleave(group, dim=1)
        return F.scaled_dot_product_attention(q.transpose(1, 2), k, v,
                                              attn_mask=mask)

    return library


def serve_shape_timings(torch, kpaged, gen, n: int) -> dict:
    """Both kernels at the decode shapes phases 18, 19 and 20 serve
    (``SERVE_SHAPES``), bf16, unpoisoned, cycling over the model's layers'
    pools: ms per call, the plain version's, the device µs per call and
    launch grid from a trace, the byte / operation bound, and for the
    Softmax the library yardstick's ms and device µs (``sdpa_library``)
    and its distance from the kernel."""
    out = {}
    for arch, (shape, layers) in SERVE_SHAPES.items():
        out[arch] = {"shape": dataclasses.asdict(shape), "layers": layers}
        for name in ("paged_inhibitor", "paged_attention"):
            fwd, plain = kernel_fns(kpaged, name)
            q, kp, vp, tables, lengths = make_pools(
                gen, torch.bfloat16, layers, poison=False,
                qk_std=shape.qk_std[name], shape=shape)

            def kernel(i):
                return fwd(q, kp[i % layers], vp[i % layers], tables,
                           lengths, window=shape.window)

            t = {"ms": cuda_ms(kernel, n),
                 "plain_ms": cuda_ms(lambda i: plain(
                     q, kp[i % layers], vp[i % layers], tables, lengths,
                     window=shape.window), 10)}
            dev = device_us(kernel, 100, grids=True)
            t.update(device_us=dev["us"],
                     kernels_per_call=dev["kernels_per_call"],
                     trace_attempts=dev["trace_attempts"],
                     grids=dev["grids"])
            t.update(bound(name, q, tables, lengths, shape.window, 2, shape))
            t["library_ms"] = None
            if name == "paged_attention":
                library = sdpa_library(torch, q, kp, vp, tables, lengths,
                                       shape, layers)
                t["library_ms"] = cuda_ms(library, 100)
                t["library_device_us"] = device_us(library, 100)["us"]
                t["library_max_abs_err"] = (
                    library(0).transpose(1, 2).float()
                    - kernel(0).float()).abs().max().item()
            out[arch][name] = t
            del q, kp, vp
    torch.cuda.empty_cache()
    return out


SERVE_ENGINE = dict(max_batch=8, max_len=512, page_size=16, prefix_cache=True)
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 8, 128, 32
# in a second wave of the same traffic (after the timed one), the
# decode-only tick whose device time is traced (then the next, when the
# trace lost a record)
SERVE_PROFILED_TICK = 8


def tick_device(tick, pad: int) -> dict:
    """Device time and idle share of one call of ``tick``
    (``traced_records``): ``busy_us`` is the union of its records'
    intervals, ``idle_share`` 1 - busy / the range's host span (the
    profiler slows the host), ``lost`` the runtime calls with no record."""
    records, (lo, hi), lost = traced_records(tick, pad, "serve_tick")
    busy, end = 0.0, -math.inf
    for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in records):
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"device_us": sum(float(e["dur"]) for e in records),
            "busy_us": busy, "range_us": hi - lo,
            "idle_share": 1.0 - busy / (hi - lo),
            "kernels": sum(e["cat"] == "kernel" for e in records),
            "lost": lost}


def serve_requests(Request, vocab: int, on_token=None, wave: int = 0):
    import numpy as np

    rng = np.random.default_rng(wave)
    return [Request(wave * SERVE_REQUESTS + i,
                    rng.integers(0, vocab, (SERVE_PROMPT,)),
                    max_new_tokens=SERVE_NEW, on_token=on_token)
            for i in range(SERVE_REQUESTS)]


def profile_tick(eng, reqs) -> list:
    """Serve a second wave of the phase's traffic (``reqs``) and trace one
    of its decode-only ticks with ``tick_device`` (the next one again,
    with four times the pad, when the trace lost a record; three at
    most)."""
    for r in reqs:
        eng.submit(r)
    profiled, decode_only, pad = [], 0, 1000
    while eng.active or eng.admitting or len(eng.scheduler):
        if (decode_only >= SERVE_PROFILED_TICK and not eng.admitting
                and not len(eng.scheduler) and len(profiled) < 3
                and (not profiled or profiled[-1]["lost"])):
            profiled.append(tick_device(eng.step, pad))
            pad *= 4
            continue
        chunks = eng.counters["prefill_chunks"]
        eng.step()
        decode_only += eng.counters["prefill_chunks"] == chunks
    return profiled


def phase_serve(torch, kops, arch: str):
    """Phase 4 on one arm.  With this checkout's package the engine
    warms every proven bucket (warm-up "serve": each step tuned and
    captured) and serves through CUDA-graph replays; against another
    package (``--src``) whose engine has no warm-up it serves as that
    package does, and only the common numbers are taken."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import Engine, EngineConfig, Request

    graphs = "warmup" in {f.name for f in dataclasses.fields(EngineConfig)}
    cfg = get_config(arch)
    api = get_model(cfg)
    t0 = time.perf_counter()
    params = api.init(torch.Generator().manual_seed(0), device="cuda")
    init_s = time.perf_counter() - t0
    ecfg = dict(SERVE_ENGINE, **({"warmup": "serve"} if graphs else {}))
    t0 = time.perf_counter()
    eng = Engine(api, params, EngineConfig(**ecfg), device="cuda")
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    check(eng.paged and eng.decode_plan.backend == "paged_pallas",
          f"{arch}: decode plan is {eng.decode_plan}")
    built = (eng.decode_compiles, eng.prefill_compiles)
    first_token = {}                 # request id -> wall time of token 1

    def on_token(req, tok):
        first_token.setdefault(req.request_id, time.perf_counter())

    reqs = serve_requests(Request, cfg.vocab_size, on_token)
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
    ticks = stats["decode_ticks"]
    check(all(r.output is not None and len(r.output) == SERVE_NEW
              for r in reqs),
          f"{arch}: not every request finished with {SERVE_NEW} tokens")
    check(counts[kernel] == ticks * cfg.num_layers,
          f"{arch}: {kernel} launched {counts[kernel]} times, expected "
          f"{ticks} ticks x {cfg.num_layers} layers")
    check(all(n == 0 for name, n in counts.items() if name != kernel),
          f"{arch}: unexpected launches {counts}")
    gen_tokens = stats["generated_tokens"]
    profiled = profile_tick(eng, serve_requests(Request, cfg.vocab_size,
                                                wave=1))
    tick = profiled[-1] if profiled else None
    out = {"phase": "serve", "arch": arch, "graphs": graphs,
           "init_s": init_s, "construct_s": construct_s,
           "requests": len(reqs), "prompt_len": SERVE_PROMPT,
           "new_tokens": SERVE_NEW, "generated_tokens": gen_tokens,
           "wall_s": wall, "tok_per_s": gen_tokens / wall,
           "ticks": len(tick_ms), "decode_ticks": ticks,
           "prefill_chunks": stats["prefill_chunks"],
           "decode_tick_ms_p50": statistics.median(decode_only_ms),
           "decode_only_ticks": len(decode_only_ms),
           "ttft_ms_p50": statistics.median(
               (first_token[i] - submitted[i]) * 1e3 for i in submitted),
           "itl_ms_p50": stats["itl_ms_p50"], "launches": counts,
           "profiled_tick": tick, "profile_attempts": len(profiled),
           # the profiled tick's device time against the unprofiled
           # decode-only tick p50 (the profiler slows the host)
           "idle_share_at_p50": (
               None if tick is None or tick["lost"] else
               1.0 - tick["device_us"] * 1e-3 / statistics.median(
                   decode_only_ms)),
           "high_water_pages": stats["high_water_pages"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "prefill_compiles": eng.prefill_compiles,
           "decode_compiles": eng.decode_compiles}
    from repro_torch.analysis import serve_static
    if hasattr(serve_static, "engine_desc"):
        # the serve analysis cross-checks these counts against the proof
        out["engine"] = serve_static.engine_desc(eng)
    if graphs:
        out.update(serve_graph_checks(kops, arch, cfg, api, params, eng,
                                      stats, reqs, built, counts, kernel,
                                      Engine, EngineConfig, Request, ecfg))
    emit(out)
    # the engine and its steps' bodies refer to each other: collect the
    # cycle so its graphs and pools go before the next phase
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return kernel, counts[kernel], out


def serve_graph_checks(kops, arch, cfg, api, params, eng, stats, reqs, built,
                       counts, kernel, Engine, EngineConfig, Request,
                       ecfg) -> dict:
    """The graph checks of phase 4, on ``stats`` read after the timed
    wave: every tick a replay of a step built at construction, launches
    = replays x captured = ticks x layers, the step counts within the
    proven budget, every decode bucket's paged choice timed, and the
    tokens equal to the same engine's steps run eagerly (never captured)
    on the card, with the registry's tuned choices."""
    from repro_torch.analysis.serve_static import enumerate_decode_buckets
    from repro_torch.core.mechanism import (kernel_family,
                                            resolve_mechanism_name)

    g = stats["graphs"]
    budget = stats["retrace_budget"]
    ticks = stats["decode_ticks"]
    check((eng.decode_compiles, eng.prefill_compiles) == built,
          f"{arch}: steps built while serving: {built} at construction, "
          f"{(eng.decode_compiles, eng.prefill_compiles)} after")
    check(g["decode_replays"] == ticks,
          f"{arch}: {g['decode_replays']} decode replays for {ticks} ticks")
    check(g["captures"] == eng.decode_compiles + eng.prefill_compiles,
          f"{arch}: {g['captures']} captures for "
          f"{eng.decode_compiles + eng.prefill_compiles} steps")
    replayed = g["replayed_launches"].get(kernel, 0)
    check(replayed == counts[kernel] == ticks * cfg.num_layers,
          f"{arch}: replays x captured = {replayed}, counted "
          f"{counts[kernel]}, ticks x layers = {ticks * cfg.num_layers}")
    check(eng.decode_compiles <= budget["decode_proven"]
          and eng.prefill_compiles <= budget["prefill_proven"],
          f"{arch}: steps {eng.decode_compiles} / {eng.prefill_compiles} "
          f"over the proven {budget}")
    a = cfg.attention
    family = kernel_family(resolve_mechanism_name(a))
    widths = enumerate_decode_buckets(
        max_len=eng.cfg.max_len, page_size=eng.cfg.page_size,
        pages_per_slot=eng.alloc.pages_per_slot)
    choices = {}
    for hw in widths:
        d = kops.registry.decisions.get(
            ("paged", family, hw, eng.cfg.page_size, a.num_heads,
             a.num_kv_heads, a.head_dim))
        check(d is not None and d["source"] == "timed",
              f"{arch}: decode bucket {hw}: registry decision {d}")
        choices[hw] = d["choice"].pages_per_step

    class NeverCaptured(Engine):
        """The same engine, its steps run eagerly every time."""

        def _capture(self, step):
            return None

    t0 = time.perf_counter()
    ref = NeverCaptured(api, params, EngineConfig(**ecfg), device="cuda")
    ref_reqs = serve_requests(Request, cfg.vocab_size)
    for r in ref_reqs:
        ref.submit(r)
    ref.run_to_completion()
    eager_s = time.perf_counter() - t0
    check(ref.stats()["graphs"]["captures"] == 0, f"{arch}: eager ref "
          "captured a graph")
    same = [r.output for r in ref_reqs] == [r.output for r in reqs]
    check(same, f"{arch}: graphed tokens differ from the eager steps'")
    del ref
    return {"steps": {"decode": eng.decode_compiles,
                      "prefill": eng.prefill_compiles,
                      "decode_proven": budget["decode_proven"],
                      "prefill_proven": budget["prefill_proven"]},
            "graph_stats": g, "pages_per_step": choices,
            "tokens_equal_eager_steps": same, "eager_ref_s": eager_s}


def phase_serve_trace(torch):
    """The serve launcher at full width with --trace-out and --log-json:
    it must exit 0 and its trace must pass the port's validator."""
    import io

    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve.telemetry import validate_chrome_trace

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        lines = io.StringIO()
        with contextlib.redirect_stdout(lines):
            rc = launch_serve.main([
                "--arch", "smollm-135m@inhibitor", "--full", "--device",
                "cuda", "--requests", "4", "--max-batch", "4",
                "--max-len", "256", "--prompt-len", "40",
                "--new-tokens", "8", "--trace-out", path, "--log-json"])
        check(rc == 0, f"serve launcher exited {rc}")
        with open(path) as f:
            doc = json.load(f)
    v = validate_chrome_trace(doc)
    check(v["ok"], f"serve launcher trace invalid: {v['errors'][:5]}")
    ticks = [json.loads(ln) for ln in lines.getvalue().splitlines()
             if ln.startswith("{")]
    check(ticks and ticks[-1]["finished_total"] == 4,
          f"--log-json lines: {ticks[-1:]}")
    emit({"phase": "serve_trace", "summary": v["summary"],
          "log_json_lines": len(ticks),
          "decode_plan": doc["otherData"]["meta"].get("decode_plan")})


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


# the backward kernel against its plain version, the analytic VJP run on
# float32 copies of the same operands, q and k of stddev 1/sqrt(d) free
# and on a 2^-6 grid.  Free, the two sum the score Z in other orders, so an
# indicator 1[|v| > Z] or a gate 1[raw > alpha] within rounding of its tie
# may fall on one side only and move a row by a whole term: the tie
# allowance (kernels.ref.inhibitor_bwd_tie_allowance) is added, and must
# stay under 2% of each gradient by norm.  On the grid every sum of |q - k|
# is exact and both compute Z, each indicator and each gate alike.  The
# rest is float32 summation order over up to n_k terms of either sign,
# and in bf16 the kernel's single rounding of each element
FLASH_BWD_TOL = ("1e-5 |ref| + 1e-5 max|ref| (bf16: + 2^-7 |ref|); free q, "
                 "k: + the tie allowance, under 2% by norm; on a 2^-6 grid: "
                 "none")
BWD_TIE_SHARE = 0.02


def bwd_operands(torch, gen, dtype, b, n, d=D, grid=False):
    """q, k, v, g for the backward kernel at smollm-135m's heads: q and k
    of stddev 1/sqrt(d) (with ``grid`` on a 2^-6 grid), v and g unit
    normal."""
    q, k, v = flash_operands(torch, gen, "flash_inhibitor", torch.float32,
                             b, n, d=d)
    g = torch.randn(q.shape, generator=gen, device=gen.device)
    if grid:
        q, k = (torch.round(x * 64) / 64 for x in (q, k))
    return tuple(x.to(dtype) for x in (q, k, v, g))


def bwd_parity_checks(torch, gen, results: dict) -> None:
    """The backward kernel's dq, dk and dv against its plain version at
    the train phase's shape (bf16) and at FLASH_INHIBITOR_CASES' shapes
    (bf16 and float32), free and on the grid, each non-vacuous
    (``record``); two calls give the same bits."""
    from repro_torch.kernels import inhibitor as kinh
    from repro_torch.kernels import ref as kref

    cases = [(dict(), TRAIN_B, TRAIN_N, D, (torch.bfloat16,))]
    cases += [(kw, b, n, d, (torch.bfloat16, torch.float32))
              for _, kw, b, n, d in FLASH_INHIBITOR_CASES]
    ties_share = 0.0
    for kw, b, n, d, dtypes in cases:
        for dtype, grid in [(t, on) for t in dtypes for on in (False, True)]:
            q, k, v, g = bwd_operands(torch, gen, dtype, b, n, d, grid)
            label = (f"{kw} b={b} n={n} d={d} {dtype} "
                     f"{'grid' if grid else 'free'}")
            got = kinh.flash_inhibitor_bwd(q, k, v, g, **kw)
            again = kinh.flash_inhibitor_bwd(q, k, v, g, **kw)
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"flash_inhibitor_bwd {label}: two calls differ")
            q, k, v, g = (x.float() for x in (q, k, v, g))
            want = kinh.flash_inhibitor_bwd_plain(q, k, v, g, **kw)
            control = kinh.flash_inhibitor_bwd_plain(
                q, k, v.roll(1, dims=1), g, **kw)
            allow = (0.0, 0.0, 0.0)
            if not grid:
                allow = kref.inhibitor_bwd_tie_allowance(q, k, v, g,
                                                         **kw)[:3]
            for key, x, w, c, a in zip(("dq", "dk", "dv"), got, want,
                                       control, allow):
                tol = 1e-5 * w.abs() + 1e-5 * w.abs().max() + a
                if dtype == torch.bfloat16:
                    tol = tol + 2.0 ** -7 * w.abs()
                record(torch, results, "flash_inhibitor_bwd",
                       f"{key} {label}", x, w, c, tol)
                if not grid:
                    share = float(a.expand_as(w).norm() / w.norm())
                    check(share <= BWD_TIE_SHARE,
                          f"flash_inhibitor_bwd {key} {label}: tie "
                          f"allowance {share} of the norm")
                    ties_share = max(ties_share, share)
            del got, again, want, control, allow
    results["flash_inhibitor_bwd"]["tol"] = FLASH_BWD_TOL
    results["flash_inhibitor_bwd"]["tie_allowance_share_max"] = ties_share


def flash_fns(name):
    from repro_torch.kernels import flash as kflash
    from repro_torch.kernels import inhibitor as kinh

    if name == "flash_inhibitor":
        return kinh.flash_inhibitor_fwd, kinh.flash_inhibitor_plain
    return kflash.flash_attention_fwd, kflash.flash_attention_plain


def flash_operands(torch, gen, name, dtype, b, n_q, n_k=None, d=D,
                   heads=H, kv_heads=H_KV):
    """q (b, n_q, heads, d), k / v (b, n_k, kv_heads, d) on ``gen``'s
    device (smollm-135m's 9 / 3 heads by default); q and k of stddev
    1/sqrt(d) for the inhibitor (see QK_STD), 1 for the Softmax; v unit
    normal."""
    n_k = n_k or n_q
    std = d ** -0.5 if name == "flash_inhibitor" else 1.0

    def mk(shape, scale):
        return (torch.randn(shape, generator=gen, device=gen.device)
                * scale).to(dtype)

    return (mk((b, n_q, heads, d), std), mk((b, n_k, kv_heads, d), std),
            mk((b, n_k, kv_heads, d), 1.0))


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


def flash_bound(name: str, b: int, n: int, elem: int, heads: int = H,
                kv_heads: int = H_KV, d: int = D, causal: bool = True) -> dict:
    """Least time at (b, n), causal or not (smollm-135m's heads by
    default): q, k, v read and out written once (the inhibitor's
    backward: q, k, v, g read, dq, dk, dv written); the operations on each
    attended (query head, key) pair: the inhibitor as float32
    instructions that are not FMAs on the CUDA cores (no tensor core
    computes a sum of absolute differences), the Softmax products on the
    bf16 tensor cores (float32: FMAs on the CUDA cores)."""
    inhibitor = name.startswith("flash_inhibitor")
    nbytes = elem * (2 * b * n * heads * d + 2 * b * n * kv_heads * d)
    if name == "flash_inhibitor_bwd":   # g read, dq, dk, dv written
        nbytes = elem * (3 * b * n * heads * d + 4 * b * n * kv_heads * d)
    pairs = b * heads * (n * (n + 1) // 2 if causal else n * n)
    ops = OPS_PER_ELEMENT[name] * pairs * d
    if name == "flash_inhibitor":   # the prefix sums of v, added per query
        ops += b * n * (kv_heads + heads) * d
    rate = (FP32_INSTR_PER_S if inhibitor
            else FP32_OPS_PER_S if elem == 4 else BF16_TENSOR_OPS_PER_S)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


# the flash kernels at the shapes phases 20-22 first run them:
# seamless-m4t-large-v2's non-causal encoder (b 2 x 4,096 frames, 16 / 16
# heads of 64: group 1) and causal teacher-forced decoder (b 2 x 1,024),
# llava-next-mistral-7b's image prefill (b 1 x 2,880 image + 128 text
# positions, causal, 32 / 8 heads of 128: group 4); phase 22's training
# forwards: seamless's encoder (b 4 x 1,024 frames, non-causal; its
# decoder's 512 tokens stay below the kernel's threshold) and llava's
# (b 2 x (2,880 + 256) positions, causal).  (label, batch, n, heads, kv
# heads, head_dim, causal)
FLASH_FAMILY_SHAPES = [
    ("seamless encoder", 2, 4096, 16, 16, 64, False),
    ("seamless decoder", 2, 1024, 16, 16, 64, True),
    ("llava image prefill", 1, 3008, 32, 8, 128, True),
    ("seamless train encoder", 4, 1024, 16, 16, 64, False),
    ("llava train", 2, 3136, 32, 8, 128, True),
]


def ptxas_registers(ptxas: list, *needles: str) -> dict:
    """Each compiled entry whose mangled name holds every needle -> its
    ptxas register line (the build's ``-Xptxas -v`` output)."""
    out, entry = {}, None
    for line in ptxas:
        if "entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "registers" in line and entry is not None:
            if all(n in entry for n in needles):
                out[entry] = line.split(":", 1)[-1].strip()
            entry = None
    return out


def flash_family_shapes(torch, kops, results: dict, gen) -> dict:
    """Both flash kernels at ``FLASH_FAMILY_SHAPES``: in bf16 and float32
    one call each, which must be one launch of the kernel and no plain
    call, held against the plain version (``record``: tolerance, share
    above it, V-rolled control outside); the query tile each launch takes;
    then in bf16 (two input sets cycled, beyond the L2) the kernel's ms and
    device µs per call, the plain version's ms, the bound and, for the
    Softmax, SDPA's ms and device µs and its distance from the kernel."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash as kflash
    from repro_torch.kernels import inhibitor as kinh

    out = {}
    for label, b, n, heads, kv_heads, d, causal in FLASH_FAMILY_SHAPES:
        group = heads // kv_heads
        shape = {"batch": b, "n": n, "heads": heads, "kv_heads": kv_heads,
                 "head_dim": d, "group": group, "causal": causal}
        for name in ("flash_inhibitor", "flash_attention"):
            fwd, plain = flash_fns(name)
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v = flash_operands(torch, gen, name, dtype, b, n, d=d,
                                         heads=heads, kv_heads=kv_heads)
                kops.reset_counts()
                got = fwd(q, k, v, causal=causal)
                torch.cuda.synchronize()
                c = kops.counts()
                check(c[name] == 1 and c[name + "_plain"] == 0,
                      f"{name} {label} {dtype}: counts {c}")
                ref = plain(q, k, v, causal=causal)
                record(torch, results, name, f"{label} {dtype}", got, ref,
                       plain(q, k, v.roll(1, dims=1), causal=causal),
                       flash_tol(torch, ref, dtype, n))
                del q, k, v, got, ref
            if name == "flash_inhibitor":
                tiles = {"bfloat16": kinh.BLOCK_Q, "float32": kinh.BLOCK_Q}
            else:
                bq = kflash.DEFAULT_BLOCK_Q
                tiles = {"bfloat16": kinh._block_q(group, d, bq,
                                                   kflash.BLOCK_QS),
                         "float32": kinh._block_q(group, d, bq, None)}
            sets = [flash_operands(torch, gen, name, torch.bfloat16, b, n,
                                   d=d, heads=heads, kv_heads=kv_heads)
                    for _ in range(2)]

            def kernel(i):
                return fwd(*sets[i % 2], causal=causal)

            t = {"shape": shape, "block_q": tiles, "ms": cuda_ms(kernel, 20),
                 "plain_ms": cuda_ms(lambda i: plain(*sets[i % 2],
                                                     causal=causal), 1,
                                     warm=1)}
            dev = device_us(kernel, 10)
            t.update(device_us=dev["us"],
                     kernels_per_call=dev["kernels_per_call"],
                     trace_attempts=dev["trace_attempts"])
            t["library_ms"] = None
            if name == "flash_attention":
                def library(i):
                    q, k, v = (x.transpose(1, 2) for x in sets[i % 2])
                    return F.scaled_dot_product_attention(
                        q, k, v, is_causal=causal, enable_gqa=True)

                t["library_ms"] = cuda_ms(library, 20)
                t["library_device_us"] = device_us(library, 10)["us"]
                t["library_max_abs_err"] = (
                    library(0).transpose(1, 2).float()
                    - kernel(0).float()).abs().max().item()
            t.update(flash_bound(name, b, n, 2, heads, kv_heads, d, causal))
            out.setdefault(label, {})[name] = t
            del sets
        torch.cuda.empty_cache()
    return out


def phase_flash_parity(torch, kops, ptxas=()):
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
    # the inhibitor's backward kernel: parity, then at the train shape its
    # time beside the bound and the plain version's (four sets cycled)
    from repro_torch.kernels import inhibitor as kinh

    bwd_parity_checks(torch, gen, results)
    sets = [bwd_operands(torch, gen, torch.bfloat16, TRAIN_B, TRAIN_N)
            for _ in range(4)]
    t = {"ms": cuda_ms(lambda i: kinh.flash_inhibitor_bwd(*sets[i % 4]), 20),
         "plain_ms": cuda_ms(lambda i: kinh.flash_inhibitor_bwd_plain(
             *sets[i % 4]), 2, warm=1), "library_ms": None}
    dev = device_us(lambda i: kinh.flash_inhibitor_bwd(*sets[i % 4]), 20)
    t.update(device_us=dev["us"], kernels_per_call=dev["kernels_per_call"],
             trace_attempts=dev["trace_attempts"])
    t.update(flash_bound("flash_inhibitor_bwd", TRAIN_B, TRAIN_N, 2))
    timings["flash_inhibitor_bwd"] = t
    del sets
    timings["family_shapes"] = flash_family_shapes(torch, kops, results, gen)
    emit({"phase": "flash_parity", "heads": H, "kv_heads": H_KV,
          "head_dim": D, "cursors": {"q_offset": CURSOR_OFFS,
                                     "kv_valid_len": CURSOR_VALID},
          "timing_shapes": {"batch": TRAIN_B, "n": TRAIN_N,
                            "causal": True, "dtype": "bfloat16",
                            "flash_attention_block_q": kflash.DEFAULT_BLOCK_Q},
          "ptxas_d128": ptxas_registers(list(ptxas), "flash", "Li128E"),
          "results": results, "timings": timings})
    return results, timings


# phase 6a: (label, kernels, forward only, batch, n, heads, kv heads,
# head_dim, window, M) -- smollm-135m's attention at the train shape over
# 4 ``model`` ranks, hymba-1.5b's over 16 at 4,096 positions (its first
# slices lie inside the 1,024-key window's reach, the later ones slide)
QUERY_SPLIT_SHAPES = [
    ("smollm-135m", ("flash_inhibitor", "flash_attention"), (), 8, 1024,
     9, 3, 64, None, 4),
    ("hymba-1.5b", ("flash_attention", "flash_inhibitor"),
     ("flash_inhibitor",), 1, 4096, 25, 5, 64, 1024, 16),
]
# the backward is held in float32 (the training entries at float32
# operands: the forward kernel's float32 variant, then the same VJP): in
# bf16 each slice's dk and dv are rounded per query head before the GQA
# group's heads are summed, so a slice's part carries roundings of terms
# that cancel in the whole and no per-element bound of its own
QUERY_SPLIT_GRAD_TOL = ("float32: 1e-5 (sum of |each slice's part| + "
                        "|whole|) + 1e-5 max|whole|: float32 sums over "
                        "the query rows in another grouping")


def slice_bound(name: str, b: int, n_q: int, off: int, heads: int,
                kv_heads: int, d: int, window, elem: int) -> dict:
    """Least time for one query slice at ``off``: q and out of its n_q
    rows and K, V of the keys its rows attend (causal: 0 .. off + n_q - 1,
    from off - window + 1 with a window) moved once; the operations of
    :func:`flash_bound` on its attended (query head, key) pairs."""
    lo = max(0, off - window + 1) if window else 0
    keys = off + n_q - lo
    nbytes = elem * (2 * b * n_q * heads * d + 2 * b * keys * kv_heads * d)
    pairs = b * heads * sum(min(p + 1, window) if window else p + 1
                            for p in range(off, off + n_q))
    ops = OPS_PER_ELEMENT[name] * pairs * d
    if name == "flash_inhibitor":   # the prefix sums of v, added per query
        ops += b * (keys * kv_heads + n_q * heads) * d
    rate = (FP32_INSTR_PER_S if name == "flash_inhibitor"
            else FP32_OPS_PER_S if elem == 4 else BF16_TENSOR_OPS_PER_S)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def slice_device_us(torch, launch, m: int, attempts: int = 3) -> list:
    """Each of ``m`` slices' device µs: ``launch(i)`` for i < m, once
    each, in one ``traced_records`` range; the flash kernels' records in
    launch order, one a slice (a range that lost any record is traced
    again with four times the pad)."""
    for i in range(m):
        launch(i)
    torch.cuda.synchronize()
    pad = 1000
    for attempt in range(1, attempts + 1):
        records, _, lost = traced_records(
            lambda: [launch(i) for i in range(m)], pad, "query_split")
        hits = sorted((e for e in records if e["cat"] == "kernel"
                       and "flash" in e["name"]), key=lambda e: e["ts"])
        if lost == 0 and len(hits) == m:
            return [float(e["dur"]) for e in hits]
        check(attempt < attempts, f"query_split: {len(hits)} flash kernel "
              f"records of {m} slices, {lost} records lost")
        pad *= 4
    return []


def query_split_case(torch, kops, results, gen, label, name, backward, b,
                     n, heads, kv_heads, d, window, m) -> dict:
    """One kernel on the ``m`` query slices of one attention (see phase
    6a); returns its timings and checks."""
    plain = flash_fns(name)[1]
    entry = kops.flash_inhibitor if name == "flash_inhibitor" \
        else kops.flash_attention
    bf16 = torch.bfloat16
    q, k, v = flash_operands(torch, gen, name, bf16, b, n, d=d, heads=heads,
                             kv_heads=kv_heads)
    g = torch.randn(q.shape, generator=gen, device="cuda").to(bf16)
    s = n // m
    kw = dict(causal=True, window=window)

    # each rank's queries, projected from its own positions: contiguous
    qs = [q[:, i * s:(i + 1) * s].contiguous() for i in range(m)]

    def launch(i, offset=None):
        return entry(qs[i], k, v, q_offset=i * s if offset is None
                     else offset, **kw)

    kops.reset_counts()
    with torch.no_grad():
        out = torch.cat([launch(i) for i in range(m)], dim=1)
    torch.cuda.synchronize()
    c = kops.counts()
    check(c[name] == m and c[name + "_plain"] == 0,
          f"query_split {label} {name}: counts {c} for {m} slices")
    launches = c[name]
    with torch.no_grad():
        whole = entry(q, k, v, **kw)
        ref = plain(q, k, v, **kw)
        control = torch.cat([launch(i, 0) for i in range(m)], dim=1)
    tol = flash_tol(torch, ref, bf16, n)
    record(torch, results, name, f"query_split {label} M={m} bf16", out,
           ref, control, tol)
    err_whole = (out.float() - whole.float()).abs()
    check(bool((err_whole <= tol).all()),
          f"query_split {label} {name}: slices differ from the whole call "
          f"by {err_whole.max().item()}")
    t = {"shape": {"batch": b, "n": n, "heads": heads, "kv_heads": kv_heads,
                   "head_dim": d, "window": window, "slices": m,
                   "n_q": s},
         "launches": launches,
         "bit_equal_whole": bool(torch.equal(out, whole)),
         "max_abs_err_whole": err_whole.max().item(),
         "max_abs_err_plain": (out.float() - ref.float()).abs().max().item(),
         "control_err_over_tol": ((control.float() - ref.float()).abs()
                                  / tol).max().item()}
    del whole, ref, control, out
    if backward:
        q32, k32, v32, g32 = (x.float() for x in (q, k, v, g))
        leaves = [x.requires_grad_() for x in (q32.clone(), k32.clone(),
                                               v32.clone())]
        want = torch.autograd.grad(entry(*leaves, **kw), leaves, g32)
        kops.reset_counts()
        dq, dk, dv, mag = [], 0.0, 0.0, [0.0, 0.0]
        for i in range(m):
            off = i * s
            qi = q32[:, off:off + s].clone().requires_grad_()
            kv = [x.clone().requires_grad_() for x in (k32, v32)]
            gq, gk, gv = torch.autograd.grad(
                entry(qi, *kv, q_offset=off, **kw), [qi] + kv,
                g32[:, off:off + s].contiguous())
            dq.append(gq)
            dk = dk + gk
            dv = dv + gv
            mag = [mag[0] + gk.abs(), mag[1] + gv.abs()]
        c = kops.counts()
        bwd = BACKWARD_KERNEL.get(name)
        check(c[name] == m and c[name + "_plain"] == 0
              and (bwd is None or (c[bwd], c[bwd + "_plain"]) == (m, 0)),
              f"query_split {label} {name} backward: counts {c}")
        launches += c[name]
        dq = torch.cat(dq, dim=1)
        errs = {}
        for key, got, w, parts in (("dq", dq, want[0], None),
                                   ("dk", dk, want[1], mag[0]),
                                   ("dv", dv, want[2], mag[1])):
            parts = got.abs() if parts is None else parts
            gtol = 1e-5 * (parts + w.abs()) + 1e-5 * w.abs().max()
            err = (got - w).abs()
            check(bool((err <= gtol).all()),
                  f"query_split {label} {name} {key}: {err.max().item()} "
                  f"beyond tol")
            share = (w.abs() > gtol).float().mean().item()
            check(share >= MIN_NONZERO_SHARE,
                  f"query_split {label} {name} {key}: only {share} of the "
                  f"whole gradient exceeds tol")
            errs[key] = {"max_abs_err": err.max().item(),
                         "max_err_over_tol": (err / gtol).max().item(),
                         "share_above_tol": share}
        t["backward"] = errs
        t["launches"] = launches
        del want, dq, dk, dv, mag, leaves, q32, k32, v32, g32
    us = slice_device_us(torch, lambda i: launch(i), m)
    elem = 2
    bounds = [slice_bound(name, b, s, i * s, heads, kv_heads, d, window,
                          elem) for i in range(m)]
    t["slices"] = [{"offset": i * s, "device_us": us[i],
                    "bound_ms": bounds[i]["bound_ms"],
                    "bound_by": bounds[i]["bound_by"]} for i in range(m)]
    t["device_us"] = sum(us)
    t["bound_ms"] = sum(x["bound_ms"] for x in bounds)
    t["bound_by"] = max(bounds, key=lambda x: x["bound_ms"])["bound_by"]
    t["ms"] = cuda_ms(lambda i: [launch(j) for j in range(m)], 5)
    t["whole_ms"] = cuda_ms(lambda i: entry(q, k, v, **kw), 5)
    t["plain_ms"] = cuda_ms(lambda i: plain(q, k, v, **kw), 1, warm=1)
    t["library_ms"] = None
    if name == "flash_attention":
        import torch.nn.functional as F

        # SDPA over the same slices, each with its offset's bool mask
        def library(i):
            outs = []
            for j in range(m):
                mask = offset_mask(torch, s, n, j * s, window)
                outs.append(F.scaled_dot_product_attention(
                    qs[j].transpose(1, 2), k.transpose(1, 2),
                    v.transpose(1, 2), attn_mask=mask, enable_gqa=True))
            return outs

        t["library_ms"] = cuda_ms(library, 3)
    del q, k, v, g, qs
    torch.cuda.empty_cache()
    return t


def offset_mask(torch, n_q: int, n_k: int, off: int, window):
    """(n_q, n_k) attendability of queries at off + i: causal, and within
    ``window`` keys when given."""
    qi = torch.arange(off, off + n_q, device="cuda")[:, None]
    kj = torch.arange(n_k, device="cuda")[None, :]
    m = kj <= qi
    if window:
        m = m & (kj > qi - window)
    return m


def phase_query_split(torch, kops) -> tuple:
    """6a. The flash kernels' training entries on M query slices with an
    offset (see the module docstring).  Returns (results, timings,
    launches per kernel)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    results, timings, launches = {}, {}, {}
    for (label, names, fwd_only, b, n, heads, kv_heads, d, window,
         m) in QUERY_SPLIT_SHAPES:
        for name in names:
            t = query_split_case(torch, kops, results, gen, label, name,
                                 name not in fwd_only, b, n, heads,
                                 kv_heads, d, window, m)
            timings.setdefault(label, {})[name] = t
            launches[name] = launches.get(name, 0) + t["launches"]
    for r in results.values():
        r["tol"] = FLASH_TOL
    emit({"phase": "query_split", "results": results,
          "grad_tol": QUERY_SPLIT_GRAD_TOL, "timings": timings,
          "launches": launches})
    return results, timings, launches


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
    check(train_launches_ok(counts, kernel, expected),
          f"{arch}: launches {counts}, expected {kernel} {TRAIN_STEPS} "
          f"steps x {cfg.num_layers} layers x 2 (its backward kernel x 1), "
          f"no plain call")
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
        bwd = BACKWARD_KERNEL.get(kernel)
        check(launches == 2 * cfg.num_layers and counts[kernel] == launches
              and counts[kernel + "_plain"] == 0
              and (bwd is None or (counts[bwd], counts[bwd + "_plain"])
                   == (cfg.num_layers, 0)),
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
            for blk in params["blocks"]:            # the true V again
                blk["time_mix"]["value"]["kernel"].neg_()
            # the largest ratio the free-running check holds to
            # RWKV_FREE_RATIO (plus RWKV_BLOCK_REL)
            r32 = run["float32"]
            r32["free_kernel_over_plain_max"] = max(
                (k / p for k, p in zip(r32["free_kernel_rel"],
                                       r32["free_plain_rel"]) if p > 0),
                default=None)
            del ctl, scan32
        out[f"seed_{seed}"] = run
        kept = params
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
    # the last seed's parameters, served by phase 16
    return counts["wkv6"], out, kept


# ---------------------------------------------------------------------------
# 16. serve_rwkv: rwkv6-7b served through the engine at full width and depth
# ---------------------------------------------------------------------------

# contiguous slots (the family has no KV cache); the decode step captured
# as a CUDA graph at construction (warm-up "decode"); prompts prefill in
# exact-length chunks of 32, eagerly
RWKV_SERVE_ENGINE = dict(max_batch=4, max_len=256, allocator="contiguous",
                         warmup="decode")
RWKV_SERVE_REQUESTS, RWKV_SERVE_PROMPT, RWKV_SERVE_NEW = 4, 64, 16
# the first token's logits, the engine's against the eager lm_step loop's
# (the same operations on the same shapes, so 0.0 is expected): within 5%
# of the loop's largest logit, phase 12's logits tolerance
RWKV_SERVE_LOGIT_REL = 0.05


def rwkv_requests(Request, vocab: int, wave: int, on_token=None) -> list:
    import numpy as np

    rng = np.random.default_rng(100 + wave)
    return [Request(wave * RWKV_SERVE_REQUESTS + i,
                    rng.integers(0, vocab, (RWKV_SERVE_PROMPT,)),
                    max_new_tokens=RWKV_SERVE_NEW, on_token=on_token)
            for i in range(RWKV_SERVE_REQUESTS)]


def rwkv_eager_tokens(torch, api, params, prompt, row: int, ecfg) -> tuple:
    """One request alone through an eager ``lm_step`` loop, as the engine
    runs it: the prompt in chunks of the engine's prefill width on a
    batch-1 state, then one token a step in row ``row`` of a
    ``max_batch``-row state whose other rows hold zero tokens and state.
    Returns (tokens, the first token's logits)."""
    chunk, b = ecfg.prefill_chunk, ecfg.max_batch
    with torch.no_grad():
        one = api.init_states(1, ecfg.max_len, device="cuda")
        toks = torch.from_numpy(prompt.astype("int32")).cuda()[None]
        for s in range(0, toks.shape[1], chunk):
            logits, one = api.step(params, toks[:, s:s + chunk], one)
        first = logits[0, -1]
        out = [int(first.argmax())]
        st = api.init_states(b, ecfg.max_len, device="cuda")
        for x, y in zip(st, one):
            x[:, row] = y[:, 0]
        step = torch.zeros((b, 1), dtype=torch.int32, device="cuda")
        while len(out) < RWKV_SERVE_NEW:
            step[row, 0] = out[-1]
            logits, st = api.step(params, step, st)
            out.append(int(logits[row, -1].argmax()))
    return out, first.float()


def phase_serve_rwkv(torch, kops, smi: str, params=None) -> dict:
    """16. rwkv6-7b (32 layers, d 4096, 64 WKV heads of 64, vocab 65536;
    float32 parameters, bf16 compute) through the engine at full width
    and depth: phase 12's parameters when given (its last seed), else
    the same draw.  The engine (``RWKV_SERVE_ENGINE``) serves 4 requests
    of 64 random prompt tokens, 16 new tokens each; the counts are zeroed
    just before and read just after.  Checks: every decode tick a replay
    of the one decode graph captured at construction; the steps built
    within ``retrace_budget``'s proof (which marks the family
    unbucketed); no kernel launched and no plain chunked WKV call (the
    exact scan, as the reference); the greedy tokens equal to the same
    engine's with graphs off, and to each request alone through an eager
    ``lm_step`` loop, its first token's logits within
    RWKV_SERVE_LOGIT_REL of the loop's largest; a second wave whose first
    request repeats the first wave's first prompt in the recycled slot 0
    reproduces its tokens (the admission's state reset).  Printed beside
    the card's name and power limit: TTFT, ITL and tick p50, tok/s, a
    second-wave decode tick's device time and idle share, the decode
    tick's floor (every weight read once) and peak memory."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import Engine, EngineConfig, Request

    cfg = get_config(RWKV)
    api = get_model(cfg)
    t0 = time.perf_counter()
    if params is None:
        params = api.init(torch.Generator(device="cuda").manual_seed(
            RWKV_FORWARD_SEEDS[-1]), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    class Recording(Engine):
        """The engine, recording each prefill's first-token logits (the
        (1, V) rows its sampler is handed, outside any graph)."""

        def __init__(self, *args, **kw):
            self.first_logits = []
            super().__init__(*args, **kw)

        def _select(self, logits):
            if logits.shape[0] == 1:
                self.first_logits.append(logits[0].float().clone())
            return super()._select(logits)

    class NeverCaptured(Engine):
        """The same engine, its steps run eagerly every time."""

        def _capture(self, step):
            return None

    ecfg = EngineConfig(**RWKV_SERVE_ENGINE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Recording(api, params, ecfg, device="cuda")
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    check(eng.decode_plan is None and not eng.paged and eng.prefix is None
          and not eng._bucketed, f"{RWKV}: engine is {eng.paged=} "
          f"{eng.decode_plan=} {eng._bucketed=}")
    check(eng.decode_compiles == 1
          and eng.stats()["graphs"]["captures"] == 1,
          f"{RWKV}: {eng.graph_stats()} after warm-up")
    first_token = {}

    def on_token(req, tok):
        first_token.setdefault(req.request_id, time.perf_counter())

    reqs = rwkv_requests(Request, cfg.vocab_size, 0, on_token)
    submitted = {}
    for r in reqs:
        eng.submit(r)
        submitted[r.request_id] = time.perf_counter()
    kops.reset_counts()
    tick_ms, decode_only_ms = [], []
    t0 = time.perf_counter()
    while eng.active or eng.admitting or len(eng.scheduler):
        chunks = eng.counters["prefill_chunks"]
        ts = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - ts) * 1e3
        tick_ms.append(dt)
        if eng.counters["prefill_chunks"] == chunks:
            decode_only_ms.append(dt)
        check(len(tick_ms) < 200, f"{RWKV}: engine did not drain")
    wall = time.perf_counter() - t0
    counts = kops.counts()
    stats = eng.stats()
    g, budget = stats["graphs"], stats["retrace_budget"]
    ticks = stats["decode_ticks"]
    outputs = [r.output for r in reqs]
    check(all(o is not None and len(o) == RWKV_SERVE_NEW for o in outputs),
          f"{RWKV}: not every request finished with {RWKV_SERVE_NEW} tokens")
    check(all(n == 0 for n in counts.values()),
          f"{RWKV}: the serving path launched {counts} (wkv6 must not run)")
    check(g["decode_replays"] == ticks and g["captures"] == 1
          and eng._decode_steps["contiguous"].runs == 1,
          f"{RWKV}: {g} for {ticks} decode ticks (every tick a replay of "
          "the graph captured at construction)")
    check(eng.decode_compiles <= budget["decode_proven"]
          and eng.prefill_compiles <= budget["prefill_proven"]
          and not budget["within_declared"],
          f"{RWKV}: steps {eng.decode_compiles} / {eng.prefill_compiles} "
          f"against {budget}")
    # the graphs off: the same engine class, its steps run eagerly
    t0 = time.perf_counter()
    ref = NeverCaptured(api, params, ecfg, device="cuda")
    ref_reqs = rwkv_requests(Request, cfg.vocab_size, 0)
    for r in ref_reqs:
        ref.submit(r)
    ref.run_to_completion()
    eager_engine_s = time.perf_counter() - t0
    check(ref.stats()["graphs"]["captures"] == 0,
          f"{RWKV}: the eager engine captured a graph")
    same_eager = [r.output for r in ref_reqs] == outputs
    del ref
    # each request alone through an eager lm_step loop
    t0 = time.perf_counter()
    alone, logit_err, logit_scale = [], [], []
    for i, r in enumerate(reqs):
        toks, first = rwkv_eager_tokens(torch, api, params, r.prompt, i, ecfg)
        alone.append(toks)
        logit_err.append((eng.first_logits[i] - first).abs().max().item())
        logit_scale.append(first.abs().max().item())
    eager_loop_s = time.perf_counter() - t0
    same_alone = alone == outputs
    logits_ok = all(e <= RWKV_SERVE_LOGIT_REL * m
                    for e, m in zip(logit_err, logit_scale))
    # second wave: request 0's prompt again, first, so it takes slot 0
    # again after another request's state was reset out of it; its
    # decode ticks are profiled
    wave = rwkv_requests(Request, cfg.vocab_size, 1)
    wave[0] = Request(100, reqs[0].prompt.copy(),
                      max_new_tokens=RWKV_SERVE_NEW)
    profiled = profile_tick(eng, wave)
    check(g["captures"] == eng.stats()["graphs"]["captures"],
          f"{RWKV}: a graph was captured while serving")
    recycled_same = wave[0].output == outputs[0]
    tick = profiled[-1] if profiled else None
    param_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(params))
    # apply_dense casts each float32 kernel to bf16 per call: 4 more
    # bytes an element moved than reading it once
    cast_bytes = sum(t.numel() * 4 for t in _leaves(params, "kernel"))
    gen_tokens = stats["generated_tokens"]
    out = {"phase": "serve_rwkv", "arch": RWKV, "card": smi,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "engine": dict(RWKV_SERVE_ENGINE),
           "prefill_chunk": eng.cfg.prefill_chunk,
           "requests": len(reqs), "prompt_len": RWKV_SERVE_PROMPT,
           "new_tokens": RWKV_SERVE_NEW, "init_s": init_s,
           "construct_s": construct_s, "wall_s": wall,
           "tok_per_s": gen_tokens / wall, "generated_tokens": gen_tokens,
           "ticks": len(tick_ms), "decode_ticks": ticks,
           "prefill_chunks": stats["prefill_chunks"],
           "decode_tick_ms_p50": statistics.median(decode_only_ms),
           "decode_only_ticks": len(decode_only_ms),
           "ttft_ms_p50": statistics.median(
               (first_token[i] - submitted[i]) * 1e3 for i in submitted),
           "itl_ms_p50": stats["itl_ms_p50"], "launches": counts,
           "graph_stats": g, "steps": {
               "decode": eng.decode_compiles,
               "prefill": eng.prefill_compiles,
               "prefill_widths": sorted(eng._prefill_steps),
               "decode_proven": budget["decode_proven"],
               "prefill_proven": budget["prefill_proven"],
               "within_declared": budget["within_declared"]},
           "tokens_equal_eager_engine": same_eager,
           "tokens_equal_eager_lm_step": same_alone,
           "first_logits_max_abs_err": logit_err,
           "first_logits_tol": [RWKV_SERVE_LOGIT_REL * m
                                for m in logit_scale],
           "recycled_slot_tokens_equal": recycled_same,
           "eager_engine_s": eager_engine_s, "eager_loop_s": eager_loop_s,
           "profiled_tick": tick, "profile_attempts": len(profiled),
           "idle_share_at_p50": (
               None if tick is None or tick["lost"] else
               1.0 - tick["device_us"] * 1e-3 / statistics.median(
                   decode_only_ms)),
           "param_bytes": param_bytes,
           # the tick's floor: every parameter read once
           "tick_bound_ms": param_bytes / HBM_BYTES_PER_S * 1e3,
           # what the tick moves with each matmul weight cast to bf16 per
           # call (read 4, write 2, read 2 bytes an element)
           "tick_cast_ms": (param_bytes + cast_bytes)
           / HBM_BYTES_PER_S * 1e3,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    from repro_torch.analysis.serve_static import engine_desc
    out["engine_desc"] = engine_desc(eng)
    emit(out)
    check(same_eager, f"{RWKV}: graphed tokens differ from the eager "
          "engine's")
    check(same_alone, f"{RWKV}: the engine's tokens differ from each "
          "request alone through the eager lm_step loop")
    check(logits_ok, f"{RWKV}: first-token logits {logit_err} over "
          f"{RWKV_SERVE_LOGIT_REL} x {logit_scale}")
    check(recycled_same, f"{RWKV}: a recycled slot's tokens differ from "
          "a fresh slot's")
    result = {"arch": RWKV, "engine": out["engine_desc"],
              "prefill_compiles": eng.prefill_compiles,
              "decode_compiles": eng.decode_compiles, "profiled_tick": tick}
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return result


def _leaves(tree, name=None):
    """The tensors of a parameter tree (only those under key ``name``)."""
    if isinstance(tree, dict):
        return [t for k, v in tree.items()
                for t in (_leaves(v) if k == name else _leaves(v, name))]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v, name)]
    return [tree] if name is None else []


# ---------------------------------------------------------------------------
# 17. serve_analysis: the static serve analyzer against the live engines
# ---------------------------------------------------------------------------

# the reduced rwkv6-7b rejection's engine (the reference test's)
SERVE_ANALYSIS_REJECT = dict(max_batch=2, max_len=32, page_size=8,
                             prefill_chunk=8)
LAUNCH_KERNELS = 1000


def launch_overhead(torch) -> dict:
    """The cost model's ``dispatch_s`` on this card: LAUNCH_KERNELS
    one-element kernels captured in one CUDA graph and replayed (device
    time per kernel by CUDA events: the engine's ticks are such
    replays), beside the same kernels launched eagerly (host included)."""
    x = torch.zeros(1, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            x.add_(1)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(LAUNCH_KERNELS):
            x.add_(1)
    graph_ms = cuda_ms(lambda i: graph.replay(), 20)
    eager_ms = cuda_ms(lambda i: [x.add_(1) for _ in range(LAUNCH_KERNELS)],
                       5)
    del graph
    return {"kernels": LAUNCH_KERNELS,
            "graph_s_per_kernel": graph_ms * 1e-3 / LAUNCH_KERNELS,
            "eager_s_per_kernel": eager_ms * 1e-3 / LAUNCH_KERNELS}


def phase_serve_analysis(torch, kops, smi: str, served: list) -> dict:
    """17. The static serve analyzer (``analysis.serve_static``, on the
    host; steps walked on meta tensors): ``analyze_serve`` at phase 4's
    engine config for smollm-135m, both allocators: ok, every signature
    verified, no host sync inside a step; the reduced rwkv6-7b rejected
    (prefill proven > declared); ``cross_check_bench`` over the live
    engines served before (``served``: each one's ``engine_desc`` and
    step counts) ok; no kernel launched.  For information, no gate: the
    decode tick's roofline ``est_s`` at the bucket phase 4's traffic
    used, beside phase 4's measured device time of a tick, and the
    launch overhead (``launch_overhead``) beside the cost model's
    ``dispatch_s``."""
    from repro_torch.analysis import costmodel
    from repro_torch.analysis.serve_static import (analyze_serve,
                                                   cross_check_bench,
                                                   format_serve_report)
    from repro_torch.serve.engine import decode_table_width

    kops.reset_counts()
    geom = {k: SERVE_ENGINE[k] for k in ("max_batch", "max_len",
                                         "page_size")}
    geom["prefill_chunk"] = 32
    t0 = time.perf_counter()
    doc = analyze_serve("smollm-135m", engine_kw=geom)
    smollm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rej = analyze_serve(RWKV, reduced={}, engine_kw=SERVE_ANALYSIS_REJECT)
    reject_s = time.perf_counter() - t0
    bench = {s["arch"]: {"engine": s["engine"],
                         "prefill_compiles": s["prefill_compiles"],
                         "decode_compiles": s["decode_compiles"]}
             for s in served}
    cc = cross_check_bench(bench)
    counts = kops.counts()
    width = decode_table_width(SERVE_PROMPT + SERVE_NEW,
                               page_size=SERVE_ENGINE["page_size"],
                               pages_per_slot=SERVE_ENGINE["max_len"]
                               // SERVE_ENGINE["page_size"])
    arms = {}
    for alloc, arm in doc["allocators"].items():
        roof = arm["roofline"]
        key = str(width) if alloc == "paged" else "full"
        arms[alloc] = {
            "ok": arm["ok"], "verified": arm["signatures"]["verified"],
            "host_syncs": roof["jit_host_callbacks"],
            "walked": roof["walked"],
            "decode_buckets": len(roof["decode"]["per_bucket"]),
            "decode_proven": arm["retrace"]["decode"]["proven"],
            "tick": {"bucket": key,
                     **{k: roof["decode"]["per_bucket"][key][k]
                        for k in ("flops", "hbm_bytes", "est_s", "bound")}}}
    measured = {s["arch"]: (s.get("profiled_tick") or {}).get("device_us")
                for s in served}
    overhead = launch_overhead(torch)
    out = {"phase": "serve_analysis", "card": smi,
           "engine_kw": geom, "smollm_wall_s": smollm_s,
           "reject_wall_s": reject_s, "smollm_ok": doc["ok"], "arms": arms,
           "reject": {"ok": rej["ok"], "prefill": {
               a: {k: v["retrace"]["prefill"][k]
                   for k in ("proven", "declared")}
               for a, v in rej["allocators"].items()}},
           "cross_check": cc, "measured_tick_device_us": measured,
           "launch_overhead": overhead,
           "cost_model_dispatch_s": costmodel.DEFAULT_PLATFORM.dispatch_s,
           "kernel_launches": counts,
           "report": format_serve_report(doc).splitlines()}
    emit(out)
    check(doc["ok"] and all(a["ok"] and a["verified"] and a["host_syncs"]
                            == 0 and a["decode_buckets"] == a[
                                "decode_proven"] for a in arms.values()),
          f"serve_analysis: smollm-135m not proven: {arms}")
    check(not rej["ok"] and all(
        p["proven"] > p["declared"] for p in out["reject"]["prefill"]
        .values()), f"serve_analysis: {RWKV} not rejected: {out['reject']}")
    check(cc["ok"] and len(cc["checked"]) == len(served),
          f"serve_analysis: cross-check {cc}")
    check(all(n == 0 for n in counts.values()),
          f"serve_analysis: a kernel launched {counts}")
    return out


# ---------------------------------------------------------------------------
# 18, 19. serve_moe / serve_hybrid: the MoE and hybrid families served
# through the paged engine at full width and depth
# ---------------------------------------------------------------------------

MOE = "qwen2-moe-a2.7b"
HYBRID = "hymba-1.5b"
# phase 4's engine and traffic (8 requests of 128 random tokens, 32 new):
# paged, prefix cache on, every proven bucket captured at construction
MOE_SERVE_ENGINE = dict(SERVE_ENGINE, warmup="serve")
# paged; the prefix cache asked for and refused by the family; prompts
# prefill whole at admission in exact-length chunks of 32, eagerly; every
# decode bucket (table widths 1..128) captured at construction
HYBRID_SERVE_ENGINE = dict(max_batch=4, max_len=2048, page_size=16,
                           prefill_chunk=32, prefix_cache=True,
                           warmup="decode")
# one prompt long enough that its decode reads past the 1,024-key window
HYBRID_PROMPTS, HYBRID_NEW = (1100, 64, 64, 64), 16
# cursors of the full-width decode step held kernel against gather:
# phase 5's, and for hymba around its window and past it
MOE_DECODE_LENGTHS = [0, 14, 15, 16, 99, 299, 500, 510]
HYBRID_DECODE_LENGTHS = [0, 14, 500, 1022, 1023, 1024, 1100, 2000]
# phase 5's tolerance: within 5% of the gather path's largest logit
DECODE_REL = 0.05


def moe_requests(Request, vocab: int, wave: int, on_token=None) -> list:
    return serve_requests(Request, vocab, on_token, wave)


def hybrid_requests(Request, vocab: int, wave: int, on_token=None) -> list:
    import numpy as np

    rng = np.random.default_rng(200 + wave)
    return [Request(wave * 10 + i, rng.integers(0, vocab, (n,)),
                    max_new_tokens=HYBRID_NEW, on_token=on_token)
            for i, n in enumerate(HYBRID_PROMPTS)]


FAMILY_SPECS = {
    MOE: dict(engine=MOE_SERVE_ENGINE, requests=moe_requests,
              bucketed=True, prefix=True, recycle=False,
              decode_lengths=MOE_DECODE_LENGTHS),
    HYBRID: dict(engine=HYBRID_SERVE_ENGINE, requests=hybrid_requests,
                 bucketed=False, prefix=False, recycle=True,
                 decode_lengths=HYBRID_DECODE_LENGTHS),
}


@contextlib.contextmanager
def recording(module, name: str, keep: list, args: bool = False):
    """``module.name`` wrapped to append every call's result to ``keep``,
    with ``args`` as (positional arguments, result) (the callers look the
    function up on the module at each call)."""
    orig = getattr(module, name)

    def wrapped(*a, **kwargs):
        out = orig(*a, **kwargs)
        keep.append((a, out) if args else out)
        return out

    setattr(module, name, wrapped)
    try:
        yield keep
    finally:
        setattr(module, name, orig)


def attention_params(params: dict) -> list:
    """Every attention's parameter dict in a model's tree: each block's
    ``attn``; the encoder-decoder's encoder ``attn`` and decoder
    ``self_attn`` and ``cross_attn``."""
    names = {"blocks": ("attn",), "encoder": ("attn",),
             "decoder": ("self_attn", "cross_attn")}
    return [layer[a] for stack, attns in names.items()
            for layer in params.get(stack, ()) for a in attns]


def family_params(torch, api, cfg, device: str = "cuda",
                  seed: int = 0) -> dict:
    """Float32 parameters drawn on ``device`` from a generator there (seed
    0; on the card a CPU generator would draw 15 B normals on the host);
    for the inhibitor, every wq and wk of every attention scaled by
    1/sqrt(head_dim) (QK_STD)."""
    params = api.init(torch.Generator(device=device).manual_seed(seed),
                      device=device)
    if cfg.attention.mechanism.startswith("inhibitor"):
        std = cfg.attention.head_dim ** -0.5
        with torch.no_grad():
            for attn in attention_params(params):
                attn["wq"]["kernel"].mul_(std)
                attn["wk"]["kernel"].mul_(std)
    return params


def family_decode_paths(torch, kops, cfg, params, lengths, max_len) -> dict:
    """One full-width paged decode step at cursors ``lengths`` through the
    paged kernel, through the forced gather backend, and through the
    kernel after the cached V rows are zeroed (the control), on one state
    (random K / V, K at 1/sqrt(d) for the inhibitor; zero Mamba carries),
    in the served bf16 compute and again in float32 compute on the same
    pool values.  In bf16 the two paths round differently (the kernel
    accumulates in float32 and rounds once), and an MoE layer's top-k and
    capacity turn a last-bit difference in one row's router logits into a
    different expert, or a dropped assignment of another row; float32
    compute leaves the kernel's own error.  Returns, per compute dtype,
    the errors against the gather path, the kernel's launches and, for
    the inhibitor, the share of layer 0's kernel outputs that are
    non-zero; and each bf16 path's distance to the float32 gather
    path."""
    from repro_torch.launch.profile import build_state
    from repro_torch.models import transformer as tfm

    gen = torch.Generator(device="cuda").manual_seed(1)
    st = build_state(cfg, lengths, page_size=PS, max_len=max_len, gen=gen,
                     device="cuda")
    inhibitor = cfg.attention.mechanism.startswith("inhibitor")
    if inhibitor:
        st.kv.k.mul_(cfg.attention.head_dim ** -0.5)
    tokens = torch.randint(0, cfg.vocab_size, (len(lengths), 1),
                           generator=gen, device="cuda")
    wrapper = "paged_flash_inhibitor" if inhibitor else "paged_flash_attention"
    kernel = "paged_inhibitor" if inhibitor else "paged_attention"
    out = {"lengths": lengths}
    k0, v0 = st.kv.k.clone(), st.kv.v.clone()
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    gathered = {}
    for label, run in (("bf16", cfg), ("float32", f32)):
        if label == "float32":
            tables = st.kv.block_tables
            st = build_state(f32, lengths, page_size=PS, max_len=max_len,
                             gen=gen, device="cuda")
            st.kv.block_tables.copy_(tables)       # the same pages
        kv = st.kv
        gather_cfg = dataclasses.replace(run, attention=dataclasses.replace(
            run.attention, backend="paged"))
        logits, outs = {}, []
        kops.reset_counts()
        for path, run_cfg, v_init in (("kernel", run, v0),
                                      ("gather", gather_cfg, v0),
                                      ("control", run, torch.zeros_like(v0))):
            kv.k.copy_(k0)
            kv.v.copy_(v_init)
            keep = []
            with torch.no_grad(), recording(kops, wrapper, keep):
                lg, _ = tfm.lm_step(params, run_cfg, tokens, st)
            logits[path] = lg.float()
            if path == "kernel":
                outs = keep
        ref = logits["gather"]
        scale = ref.abs().max().item()
        gathered[label] = logits
        out[label] = {
            "max_abs_err": (logits["kernel"] - ref).abs().max().item(),
            "tol": DECODE_REL * scale, "max_abs_logit": scale,
            "control_max_abs_err": (logits["control"] - ref).abs().max()
            .item(),
            "argmax_agreement": (logits["kernel"].argmax(-1)
                                 == ref.argmax(-1)).float().mean().item(),
            "finite": bool(torch.isfinite(logits["kernel"]).all()),
            "kernel_calls": len(outs), "launches": kops.counts()[kernel],
            "layer0_nonzero_share": (
                (outs[0] != 0).float().mean().item() if inhibitor and outs
                else None)}
        del outs
    truth = gathered["float32"]["gather"]
    out["bf16_vs_float32_gather"] = {
        path: (gathered["bf16"][path] - truth).abs().max().item()
        for path in ("kernel", "gather")}
    del st, k0, v0, gathered
    return out


def serve_family_arm(torch, kops, smi: str, arch: str) -> dict:
    """Phases 18 and 19 on one arm: ``arch`` at full width and depth
    (``family_params``) through the paged engine of its ``FAMILY_SPECS``
    entry.  The counts are zeroed just before the first wave is driven
    and read just after.  Checks: every request finished; the arm's
    kernel launched decode ticks x layers times (= the graphs' replayed
    launches) and every other count 0 (the plain versions never called);
    every decode tick a replay of a graph captured at construction; the
    steps built within the proven budget; every decode bucket's paged
    choice "timed"; the greedy tokens equal to the same engine's steps
    run eagerly (never captured) over the same traffic; with ``recycle``,
    a second wave whose first request repeats the first prompt in the
    recycled slot 0 reproduces its tokens; every state tensor keeps its
    storage across the waves; one full-width decode step through the
    kernel within DECODE_REL of the gather backend's, a V-zeroed control
    outside it, and on the inhibitor arm at least MIN_NONZERO_SHARE of
    layer 0's kernel outputs non-zero; peak memory under the card's.
    Printed beside the card's name and power limit: tick p50, ITL, TTFT
    (and the first request's alone), tok/s, a second-wave tick's device
    time and idle share, the tick's floor (every weight read once), peak
    memory and the MoE dropped fraction over the eager run's layers."""
    from repro_torch.analysis.serve_static import (engine_desc,
                                                   enumerate_decode_buckets)
    from repro_torch.configs import get_config
    from repro_torch.core.mechanism import (kernel_family,
                                            resolve_mechanism_name)
    from repro_torch.models.registry import get_model
    from repro_torch.nn import moe as moenn
    from repro_torch.serve.engine import Engine, EngineConfig, Request

    spec = FAMILY_SPECS[arch.split("@")[0]]
    cfg = get_config(arch)
    api = get_model(cfg)
    L = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = family_params(torch, api, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ecfg = EngineConfig(**spec["engine"])
    t0 = time.perf_counter()
    eng = Engine(api, params, ecfg, device="cuda")
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    check(eng.paged and eng.decode_plan.backend == "paged_pallas"
          and eng._bucketed == spec["bucketed"]
          and (eng.prefix is not None) == spec["prefix"],
          f"{arch}: engine paged={eng.paged} plan={eng.decode_plan} "
          f"bucketed={eng._bucketed} prefix={eng.prefix is not None}")
    built = (eng.decode_compiles, eng.prefill_compiles)
    captures = eng.graph_stats()["captures"]

    def storage():
        st = eng.states
        return [t.data_ptr() for t in (st.kv.k, st.kv.v, st.kv.length,
                                       st.kv.block_tables, st.ssm, st.conv)
                if t is not None]

    ptrs = storage()
    first_token = {}

    def on_token(req, tok):
        first_token.setdefault(req.request_id, time.perf_counter())

    reqs = spec["requests"](Request, cfg.vocab_size, 0, on_token)
    submitted = {}
    for r in reqs:
        eng.submit(r)
        submitted[r.request_id] = time.perf_counter()
    kops.reset_counts()
    tick_ms, decode_only_ms = [], []
    t0 = time.perf_counter()
    while eng.active or eng.admitting or len(eng.scheduler):
        chunks = eng.counters["prefill_chunks"]
        ts = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - ts) * 1e3
        tick_ms.append(dt)
        if eng.counters["prefill_chunks"] == chunks:
            decode_only_ms.append(dt)
        check(len(tick_ms) < 1000, f"{arch}: engine did not drain")
    wall = time.perf_counter() - t0
    counts = kops.counts()
    stats = eng.stats()
    g, budget = stats["graphs"], stats["retrace_budget"]
    ticks = stats["decode_ticks"]
    kernel = ("paged_inhibitor" if cfg.attention.mechanism.startswith(
        "inhibitor") else "paged_attention")
    outputs = [r.output for r in reqs]
    check(all(o is not None and len(o) == r.max_new_tokens
              for o, r in zip(outputs, reqs)),
          f"{arch}: not every request finished")
    check(counts[kernel] == ticks * L,
          f"{arch}: {kernel} launched {counts[kernel]} times, expected "
          f"{ticks} ticks x {L} layers")
    check(all(n == 0 for name, n in counts.items() if name != kernel),
          f"{arch}: unexpected launches {counts}")
    check(g["decode_replays"] == ticks
          and g["replayed_launches"].get(kernel, 0) == counts[kernel]
          and eng.decode_compiles == built[0] and g["captures"] == captures,
          f"{arch}: {g} for {ticks} ticks (every tick a replay of a graph "
          f"captured at construction)")
    if spec["bucketed"]:
        check(eng.prefill_compiles == built[1],
              f"{arch}: prefill steps built while serving")
    check(eng.decode_compiles <= budget["decode_proven"]
          and eng.prefill_compiles <= budget["prefill_proven"],
          f"{arch}: steps {eng.decode_compiles} / {eng.prefill_compiles} "
          f"over the proven {budget}")
    a = cfg.attention
    family = kernel_family(resolve_mechanism_name(a))
    choices = {}
    for hw in enumerate_decode_buckets(
            max_len=eng.cfg.max_len, page_size=eng.cfg.page_size,
            pages_per_slot=eng.alloc.pages_per_slot):
        d = kops.registry.decisions.get(
            ("paged", family, hw, eng.cfg.page_size, a.num_heads,
             a.num_kv_heads, a.head_dim))
        check(d is not None and d["source"] == "timed",
              f"{arch}: decode bucket {hw}: registry decision {d}")
        choices[hw] = d["choice"].pages_per_step

    class NeverCaptured(Engine):
        """The same engine, its steps run eagerly every time."""

        def _capture(self, step):
            return None

    t0 = time.perf_counter()
    ref = NeverCaptured(api, params, ecfg, device="cuda")
    ref_reqs = spec["requests"](Request, cfg.vocab_size, 0)
    moe_calls = []
    with recording(moenn, "apply_moe", moe_calls):
        for r in ref_reqs:
            ref.submit(r)
        ref.run_to_completion()
    eager_s = time.perf_counter() - t0
    check(ref.stats()["graphs"]["captures"] == 0,
          f"{arch}: the eager engine captured a graph")
    same_eager = [r.output for r in ref_reqs] == outputs
    # each layer call's dropped fraction, by the tokens it routed (a
    # decode tick's max_batch rows or a prefill chunk's width) and layer
    dropped = {}
    for i, (y, aux) in enumerate(moe_calls):
        dropped.setdefault(y.shape[0] * y.shape[1], {}).setdefault(
            i % L, []).append(float(aux.dropped_fraction))
    del ref, moe_calls
    # the second wave; its decode-only tick profiled
    wave = spec["requests"](Request, cfg.vocab_size, 1)
    if spec["recycle"]:
        wave[0] = Request(100, reqs[0].prompt.copy(),
                          max_new_tokens=reqs[0].max_new_tokens)
    profiled = profile_tick(eng, wave)
    check(eng.graph_stats()["captures"] == captures,
          f"{arch}: a graph was captured while serving")
    recycled_same = wave[0].output == outputs[0] if spec["recycle"] else None
    storage_kept = storage() == ptrs
    tick = profiled[-1] if profiled else None
    paths = family_decode_paths(torch, kops, cfg, params,
                                spec["decode_lengths"], ecfg.max_len)
    param_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    # apply_dense and the expert products cast each float32 kernel to bf16
    # per call: 4 more bytes an element moved than reading it once
    cast_bytes = sum(t.numel() * 4 for t in _leaves(params, "kernel"))
    peak = torch.cuda.max_memory_allocated()
    card = torch.cuda.get_device_properties(0).total_memory
    gen_tokens = stats["generated_tokens"]
    p50 = statistics.median(decode_only_ms)
    out = {"phase": SERVE_PHASES[cfg.family],
           "arch": arch, "card": smi, "layers": L, "d_model": cfg.d_model,
           "engine": dict(spec["engine"]),
           "prefill_chunk": eng.cfg.prefill_chunk,
           "requests": len(reqs),
           "prompt_lens": [len(r.prompt) for r in reqs],
           "new_tokens": [r.max_new_tokens for r in reqs],
           "init_s": init_s, "construct_s": construct_s, "wall_s": wall,
           "tok_per_s": gen_tokens / wall, "generated_tokens": gen_tokens,
           "ticks": len(tick_ms), "decode_ticks": ticks,
           "prefill_chunks": stats["prefill_chunks"],
           "decode_tick_ms_p50": p50,
           "decode_only_ticks": len(decode_only_ms),
           "ttft_ms_p50": statistics.median(
               (first_token[i] - submitted[i]) * 1e3 for i in submitted),
           "ttft_ms_first_request": (first_token[reqs[0].request_id]
                                     - submitted[reqs[0].request_id]) * 1e3,
           "itl_ms_p50": stats["itl_ms_p50"], "launches": counts,
           "graph_stats": g, "steps": {
               "decode": eng.decode_compiles,
               "prefill": eng.prefill_compiles,
               "prefill_widths": sorted(eng._prefill_steps),
               "decode_proven": budget["decode_proven"],
               "prefill_proven": budget["prefill_proven"],
               "within_declared": budget["within_declared"]},
           "pages_per_step": choices,
           "tokens_equal_eager_steps": same_eager, "eager_engine_s": eager_s,
           "recycled_slot_tokens_equal": recycled_same,
           "storage_kept": storage_kept,
           "profiled_tick": tick, "profile_attempts": len(profiled),
           "idle_share_at_p50": (None if tick is None or tick["lost"] else
                                 1.0 - tick["device_us"] * 1e-3 / p50),
           "decode_paths": paths, "param_bytes": param_bytes,
           # the tick's floor: every parameter read once
           "tick_bound_ms": param_bytes / HBM_BYTES_PER_S * 1e3,
           "tick_cast_ms": (param_bytes + cast_bytes)
           / HBM_BYTES_PER_S * 1e3,
           "moe_dropped_fraction": {
               f"tokens {t}": {
                   "mean": statistics.fmean(v for vs in by.values()
                                            for v in vs),
                   "calls": sum(len(vs) for vs in by.values()),
                   "by_layer": [statistics.fmean(by[i]) for i in sorted(by)]}
               for t, by in sorted(dropped.items())} or None,
           "max_memory_allocated": peak, "card_memory": card,
           "engine_desc": engine_desc(eng)}
    emit(out)
    check(same_eager, f"{arch}: graphed tokens differ from the eager steps'")
    check(recycled_same is not False, f"{arch}: a recycled slot's tokens "
          "differ from a fresh slot's")
    check(storage_kept, f"{arch}: a state tensor changed its storage")
    # held in float32 compute (the kernel's own error); in bf16 the
    # paths' rounding, amplified by MoE routing, is printed beside it
    f32 = paths["float32"]
    check(f32["finite"] and f32["max_abs_err"] <= f32["tol"],
          f"{arch}: kernel vs gather decode step {paths}")
    for label in ("bf16", "float32"):
        p = paths[label]
        check(p["finite"] and p["control_max_abs_err"] > p["tol"],
              f"{arch}: the V-zeroed control within tol ({label}): {paths}")
        check(p["kernel_calls"] == L and p["launches"] == 2 * L,
              f"{arch}: the decode step's kernel calls ({label}) {paths}")
        check(p["layer0_nonzero_share"] is None
              or p["layer0_nonzero_share"] >= MIN_NONZERO_SHARE,
              f"{arch}: layer 0's inhibitor outputs ({label}) {paths}")
    check(peak < card, f"{arch}: peak memory {peak} over the card's {card}")
    result = {"arch": arch, "kernel": kernel, "launches": counts[kernel],
              "profiled_tick": tick}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    if spec.get("extra") is not None:
        result["extra"] = spec["extra"](torch, kops, smi, arch, cfg, api,
                                        params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return result


def phase_serve_family(torch, kops, smi: str, arch: str) -> dict:
    """Phase 18 (``arch`` qwen2-moe-a2.7b), 19 (hymba-1.5b) or 20
    (llava-next-mistral-7b): the inhibitor arm, then the dot-product arm
    (``serve_family_arm``).  Returns each arm's kernel launches by kernel
    name, and the launches of its ``extra`` part by kernel name under
    ``"extra"``."""
    launches = {}
    for name in (f"{arch}@inhibitor", arch):
        arm = serve_family_arm(torch, kops, smi, name)
        launches[arm["kernel"]] = arm["launches"]
        if "extra" in arm:
            launches.setdefault("extra", {}).update(arm["extra"]["launches"])
    return launches


# ---------------------------------------------------------------------------
# 20, 21, 22. serve_vlm / encdec / train_families: the vlm and
# encoder-decoder families at full width, and training of the moe,
# hybrid, encoder-decoder and vlm families on the card
# ---------------------------------------------------------------------------

VLM = "llava-next-mistral-7b"
SEAMLESS = "seamless-m4t-large-v2"
SERVE_PHASES = {"moe": "serve_moe", "hybrid": "serve_hybrid",
                "vlm": "serve_vlm"}
# the image prefill: all 5 anyres tiles x 576 patches before 128 text
# tokens (3,008 positions), at full depth in bf16; held in float32 at
# full width and depth 4 against the plain path
VLM_PREFILL_TEXT = 128
HOLD_DEPTH = 4
# kernel forward against the plain path (float32, depth 4): max |diff|
# within FORWARD_REL of the plain output's largest magnitude; the kernels
# and the plain versions differ by float32 summation order, about 1e-6
# of an output a layer
FORWARD_REL = 1e-4
# decode steps against the teacher-forced decoder (float32, depth 4):
# the CPU tests' 2e-4, of max(1, the largest logit)
STEP_REL = 2e-4
# the plain path each mechanism's kernel is held against: the inhibitor's
# structural plain backend, the Softmax's dense one
PLAIN_BACKEND = {"flash_inhibitor": "blocked", "flash_attention": "fused"}


def plan_rows(calls: list) -> list:
    """``recording(attn, "plan_attention", calls, args=True)``'s calls as
    rows: causal, cross, n_q, n_k and the backend planned."""
    return [{"causal": cfg.causal, "cross": shapes.is_cross,
             "n_q": shapes.n_q, "n_k": shapes.n_k, "backend": plan.backend}
            for (cfg, shapes), plan in calls]


@contextlib.contextmanager
def v_shifted():
    """The control: every attention's V rolled by one key before its
    backend runs (a kernel or plain path reading the wrong keys)."""
    from repro_torch.core import attention as attn

    orig = attn.execute_plan

    def shifted(plan, q, k, v, **kw):
        return orig(plan, q, k, v.roll(1, dims=1), **kw)

    attn.execute_plan = shifted
    try:
        yield
    finally:
        attn.execute_plan = orig


def plain_cfg(cfg, kernel: str):
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, backend=PLAIN_BACKEND[kernel]))


#: the flash kernels' names in a trace (``device_us``'s ``names``)
FLASH_KERNEL_NAMES = ("flash_inhibitor_kernel", "flash_attention")


def forward_device(torch, run) -> dict:
    """Device time of one ``run()`` under no_grad, already warm, with the
    flash kernels' time and launches among its records."""
    with torch.no_grad():
        return device_us(lambda i: run(), 1, warm=0,
                         names=FLASH_KERNEL_NAMES)


def held(torch, got, ref, control, rel: float) -> dict:
    """Max |got - ref| within ``rel`` of max |ref|, the control outside."""
    scale = ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    ctl = (control.float() - ref.float()).abs().max().item()
    return {"max_abs_err": err, "tol": rel * scale, "max_abs_ref": scale,
            "control_max_abs_err": ctl,
            "ok": bool(torch.isfinite(got).all()) and err <= rel * scale
            < ctl}


def vlm_image_prefill(torch, kops, smi, arch, cfg, api, params) -> dict:
    """Phase 20's image prefill on one arm: ``api.forward`` on b 1 x
    (2,880 patch embeddings + 128 text tokens) at full depth in bf16,
    every layer planned ``pallas`` and its flash kernel launched once a
    layer (counts zeroed just before, read just after); the forward's
    wall, device time and the kernel's device µs per call beside its
    bound and SDPA's time at the same q / k / v shapes.  Then at full
    width and depth 4 in float32 the kernel forward against the plain
    path (the planner forced to ``PLAIN_BACKEND``) within FORWARD_REL,
    and the plain path with V shifted by one key outside it."""
    import torch.nn.functional as F

    from repro_torch.core import attention as attn_m
    from repro_torch.models.registry import get_model

    fe, a = cfg.frontend, cfg.attention
    n_img = fe.tokens_per_item * fe.max_tiles
    n = n_img + VLM_PREFILL_TEXT
    L = cfg.num_layers
    kernel = train_kernel(cfg)
    gen = torch.Generator(device="cuda").manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (1, VLM_PREFILL_TEXT), generator=gen,
                                     device="cuda"),
             "image_embeds": torch.randn((1, n_img, fe.embed_dim),
                                         generator=gen, device="cuda")}

    def forward():
        with torch.no_grad():
            return api.forward(params, batch)

    forward()
    torch.cuda.synchronize()
    calls = []
    kops.reset_counts()
    with recording(attn_m, "plan_attention", calls, args=True):
        t0 = time.perf_counter()
        logits = forward()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = kops.counts()
    plans = plan_rows(calls)
    check(len(plans) == L and all(p["backend"] == "pallas" and p["causal"]
                                  and p["n_q"] == n for p in plans),
          f"{arch}: image prefill plans {plans}")
    check(counts[kernel] == L and all(
        v == 0 for k, v in counts.items() if k != kernel),
        f"{arch}: image prefill launches {counts}")
    check(tuple(logits.shape) == (1, n, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{arch}: image prefill logits {tuple(logits.shape)}")
    del logits
    dev = forward_device(torch, forward)
    q = torch.randn((1, a.num_heads, n, a.head_dim), generator=gen,
                    device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((1, a.num_kv_heads, n, a.head_dim), generator=gen,
                        device="cuda").to(torch.bfloat16) for _ in range(2))

    def sdpa(i):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)

    sdpa_ms, sdpa_us = cuda_ms(sdpa, 20), device_us(sdpa, 10)["us"]
    del q, k, v
    # the float32 hold at depth HOLD_DEPTH
    f32 = dataclasses.replace(cfg.with_layers(HOLD_DEPTH),
                              compute_dtype="float32")
    p4 = dict(params, blocks=params["blocks"][:HOLD_DEPTH])
    with torch.no_grad():
        kops.reset_counts()
        got = get_model(f32).forward(p4, batch)
        hold_launches = kops.counts()[kernel]
        ref = get_model(plain_cfg(f32, kernel)).forward(p4, batch)
        with v_shifted():
            control = get_model(plain_cfg(f32, kernel)).forward(p4, batch)
    hold = held(torch, got, ref, control, FORWARD_REL)
    del got, ref, control
    out = {"phase": "vlm_image_prefill", "arch": arch, "card": smi,
           "batch": 1, "image_positions": n_img,
           "text_tokens": VLM_PREFILL_TEXT, "layers": L,
           "plans": sorted({p["backend"] for p in plans}),
           "launches": {kernel: counts[kernel]}, "wall_ms": wall * 1e3,
           "device": dev, "kernel_us_per_call": dev["named_us"] / L,
           "kernel_bound": flash_bound(kernel, 1, n, 2, a.num_heads,
                                       a.num_kv_heads, a.head_dim),
           "sdpa_ms": sdpa_ms, "sdpa_device_us": sdpa_us,
           "hold": dict(hold, depth=HOLD_DEPTH, dtype="float32",
                        plain_backend=PLAIN_BACKEND[kernel],
                        launches=hold_launches, rel=FORWARD_REL)}
    emit(out)
    check(dev["named_launches"] == L,
          f"{arch}: {dev['named_launches']} flash kernels in the trace")
    check(hold_launches == HOLD_DEPTH and hold["ok"],
          f"{arch}: float32 image prefill vs the plain path {hold}")
    torch.cuda.empty_cache()
    return out


FAMILY_SPECS[VLM] = dict(engine=MOE_SERVE_ENGINE, requests=moe_requests,
                         bucketed=True, prefix=True, recycle=False,
                         decode_lengths=MOE_DECODE_LENGTHS,
                         extra=vlm_image_prefill)

# phase 21: b 2 x the config's max_source_len (4,096) frames, 1,024
# teacher-forced target tokens, 64 greedy decode steps
ENCDEC_B, ENCDEC_TGT, ENCDEC_NEW = 2, 1024, 64
# the inhibitor arm's cross-attention over 4,096 frames: the fused form's
# (b, h, n_q, n_k, d) float32 difference cube would take 34 GB at the
# teacher-forced decoder's 1,024 queries, so the arm plans ``chunked``
# above 2,048 keys (its self-attentions take the kernel, unaffected)
ENCDEC_INHIBITOR_CHUNKED_AT = 2048


def encdec_cfg(arch: str):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if cfg.attention.mechanism.startswith("inhibitor"):
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, chunked_threshold=ENCDEC_INHIBITOR_CHUNKED_AT))
    return cfg


def greedy_steps(torch, api, params, memory, steps: int, max_len: int):
    """``steps`` greedy ``decode_step`` calls from token 0 on a contiguous
    cache: (the logits of each step (b, steps, V) in float32, the tokens
    fed (b, steps), each step's wall in ms)."""
    b = memory.shape[0]
    states = api.init_states(b, max_len, device="cuda")
    tok = torch.zeros((b, 1), dtype=torch.int64, device="cuda")
    fed, logits, walls = [], [], []
    with torch.no_grad():
        for _ in range(steps):
            fed.append(tok)
            t0 = time.perf_counter()
            lg, states = api.step(params, tok, states, {"memory": memory})
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            logits.append(lg[:, -1].float())
            tok = lg[:, -1].argmax(-1, keepdim=True)
    check(states.kv.length.tolist() == [steps] * len(states.kv.length),
          f"decode cursors {states.kv.length.tolist()}")
    return torch.stack(logits, 1), torch.cat(fed, 1), walls


def encdec_arm(torch, kops, smi: str, arch: str) -> dict:
    """Phase 21 on one arm: ``arch`` at full width and depth, parameters
    drawn on the card (``family_params``: every attention's wq and wk
    scaled on the inhibitor arm), frames b 2 x 4,096 from a seed.  The
    counts are zeroed just before each part and read just after.
    ``encode``: every encoder layer planned ``pallas``, non-causal, its
    kernel launched once a layer.  ``decode_train`` over 1,024 target
    tokens: every self-attention ``pallas``, causal, every
    cross-attention ``chunked`` or ``fused``.  64 greedy ``decode_step``
    calls on a contiguous cache (no kernel: one query a step), each
    step's logits against the teacher-forced decoder's on the tokens fed
    (bf16, printed).  At full width and depth 4 in float32: the encoder
    output through the kernel against the plain path within FORWARD_REL
    and the V-shifted control outside; the greedy steps against the
    teacher-forced decoder within STEP_REL.  Printed beside the card: the
    encoder's and the decoder's walls and device times, the decode step's
    wall p50 and device time against its floor (decoder and head weights
    read once), peak memory."""
    from repro_torch.core import attention as attn_m
    from repro_torch.models import encdec as encdec_m
    from repro_torch.models.registry import get_model

    cfg = encdec_cfg(arch)
    api = get_model(cfg)
    a = cfg.attention
    kernel = train_kernel(cfg)
    Le, Ld = cfg.encdec.encoder_layers, cfg.encdec.decoder_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = family_params(torch, api, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(6)
    src = cfg.encdec.max_source_len
    frames = torch.randn((ENCDEC_B, src, cfg.frontend.embed_dim),
                         generator=gen, device="cuda")
    tgt = torch.randint(0, cfg.vocab_size, (ENCDEC_B, ENCDEC_TGT),
                        generator=gen, device="cuda")

    def counted(fn, what: str, n_kernel: int):
        calls = []
        kops.reset_counts()
        with torch.no_grad(), recording(attn_m, "plan_attention", calls,
                                        args=True):
            t0 = time.perf_counter()
            y = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        counts = kops.counts()
        check(counts[kernel] == n_kernel and all(
            v == 0 for k, v in counts.items() if k != kernel),
            f"{arch}: {what} launches {counts}, expected {n_kernel}")
        return y, plan_rows(calls), wall, counts[kernel]

    with torch.no_grad():
        encdec_m.encode(params, cfg, frames)          # warm
        torch.cuda.synchronize()
    memory, enc_plans, enc_wall, enc_launches = counted(
        lambda: encdec_m.encode(params, cfg, frames), "encode", Le)
    check(len(enc_plans) == Le and all(
        p["backend"] == "pallas" and not p["causal"] and not p["cross"]
        and p["n_q"] == src for p in enc_plans),
        f"{arch}: encoder plans {enc_plans}")
    logits, dec_plans, dec_wall, dec_launches = counted(
        lambda: encdec_m.decode_train(params, cfg, memory, tgt), "decode",
        Ld)
    self_plans = [p for p in dec_plans if not p["cross"]]
    cross_plans = [p for p in dec_plans if p["cross"]]
    check(len(self_plans) == Ld and all(p["backend"] == "pallas"
                                        and p["causal"] for p in self_plans)
          and len(cross_plans) == Ld and all(
              p["backend"] in ("chunked", "fused") for p in cross_plans),
          f"{arch}: decoder plans {dec_plans}")
    check(tuple(logits.shape) == (ENCDEC_B, ENCDEC_TGT, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{arch}: teacher-forced logits")
    del logits
    enc_dev = forward_device(torch,
                             lambda: encdec_m.encode(params, cfg, frames))
    dec_dev = forward_device(
        torch, lambda: encdec_m.decode_train(params, cfg, memory, tgt))
    # greedy generation at full depth, bf16: ENCDEC_NEW steps, no kernel
    kops.reset_counts()
    step_logits, fed, step_ms = greedy_steps(torch, api, params, memory,
                                             ENCDEC_NEW, ENCDEC_NEW + 8)
    step_counts = kops.counts()
    check(all(v == 0 for v in step_counts.values()),
          f"{arch}: decode steps launched {step_counts}")
    with torch.no_grad():
        tf = encdec_m.decode_train(params, cfg, memory, fed).float()
    bf16_pair = {"max_abs_err": (step_logits - tf).abs().max().item(),
                 "max_abs_logit": tf.abs().max().item(),
                 "argmax_agreement": (step_logits.argmax(-1)
                                      == tf.argmax(-1)).float().mean()
                 .item()}
    del tf, step_logits
    states = api.init_states(ENCDEC_B, ENCDEC_NEW + 8, device="cuda")
    step_dev = forward_device(torch, lambda: api.step(
        params, fed[:, :1], states, {"memory": memory}))
    del states, memory
    step_bytes = sum(t.numel() * t.element_size() for t in _leaves(
        {k: params[k] for k in ("decoder", "dec_norm", "lm_head")}))
    torch.cuda.empty_cache()
    # depth HOLD_DEPTH in float32: the encoder through the kernel against
    # the plain path, and the decode steps against teacher forcing
    f32 = dataclasses.replace(cfg.with_layers(HOLD_DEPTH),
                              compute_dtype="float32")
    p4 = dict(params, encoder=params["encoder"][:HOLD_DEPTH],
              decoder=params["decoder"][:HOLD_DEPTH])
    with torch.no_grad():
        kops.reset_counts()
        m_k = encdec_m.encode(p4, f32, frames)
        hold_launches = kops.counts()[kernel]
        m_p = encdec_m.encode(p4, plain_cfg(f32, kernel), frames)
        with v_shifted():
            m_c = encdec_m.encode(p4, plain_cfg(f32, kernel), frames)
    hold = held(torch, m_k, m_p, m_c, FORWARD_REL)
    del m_p, m_c
    s_logits, s_fed, _ = greedy_steps(torch, get_model(f32), p4, m_k,
                                      ENCDEC_NEW, ENCDEC_NEW + 8)
    with torch.no_grad():
        tf = encdec_m.decode_train(p4, f32, m_k, s_fed)
    scale = max(1.0, tf.abs().max().item())
    f32_pair = {"max_abs_err": (s_logits - tf).abs().max().item(),
                "tol": STEP_REL * scale, "max_abs_logit": scale,
                "argmax_agreement": (s_logits.argmax(-1) == tf.argmax(-1))
                .float().mean().item(),
                "finite": bool(torch.isfinite(s_logits).all())}
    del m_k, s_logits, tf
    peak = torch.cuda.max_memory_allocated()
    out = {"phase": "encdec", "arch": arch, "card": smi,
           "encoder_layers": Le, "decoder_layers": Ld,
           "d_model": cfg.d_model, "batch": ENCDEC_B, "frames": src,
           "target_tokens": ENCDEC_TGT, "init_s": init_s,
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in _leaves(params)),
           "plans": {"encoder": sorted({p["backend"] for p in enc_plans}),
                     "decoder_self": sorted({p["backend"]
                                             for p in self_plans}),
                     "decoder_cross": sorted({p["backend"]
                                              for p in cross_plans})},
           "cross_chunked_threshold": a.chunked_threshold,
           "launches": {"encode": enc_launches, "decode_train": dec_launches,
                        "decode_steps": sum(step_counts.values())},
           "encode_wall_ms": enc_wall, "encode_device": enc_dev,
           "encode_kernel_us_per_call": enc_dev["named_us"] / Le,
           "encode_kernel_bound": flash_bound(
               kernel, ENCDEC_B, src, 2, a.num_heads, a.num_kv_heads,
               a.head_dim, causal=False),
           "decode_train_wall_ms": dec_wall, "decode_train_device": dec_dev,
           "decode_train_kernel_us_per_call": dec_dev["named_us"] / Ld,
           "decode_train_kernel_bound": flash_bound(
               kernel, ENCDEC_B, ENCDEC_TGT, 2, a.num_heads, a.num_kv_heads,
               a.head_dim),
           "decode_steps": ENCDEC_NEW,
           "step_wall_ms_p50": statistics.median(step_ms),
           "step_wall_ms": step_ms, "step_device": step_dev,
           "step_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
           "step_bytes": step_bytes, "bf16_steps_vs_teacher": bf16_pair,
           "float32": {"depth": HOLD_DEPTH, "encoder_vs_plain": dict(
               hold, plain_backend=PLAIN_BACKEND[kernel],
               launches=hold_launches, rel=FORWARD_REL),
               "steps_vs_teacher": f32_pair},
           "max_memory_allocated": peak}
    emit(out)
    check(enc_dev["named_launches"] == Le
          and dec_dev["named_launches"] == Ld,
          f"{arch}: flash kernels in the traces {enc_dev} {dec_dev}")
    check(hold_launches == HOLD_DEPTH and hold["ok"],
          f"{arch}: float32 encoder vs the plain path {hold}")
    check(f32_pair["finite"] and f32_pair["max_abs_err"] <= f32_pair["tol"],
          f"{arch}: float32 decode steps vs teacher forcing {f32_pair}")
    del params, frames, p4
    gc.collect()
    torch.cuda.empty_cache()
    return {"kernel": kernel, "launches": enc_launches + dec_launches}


def phase_encdec(torch, kops, smi: str) -> dict:
    """Phase 21: the inhibitor arm, then the dot-product arm.  Returns
    each arm's kernel launches (encode and decode_train) by kernel."""
    launches = {}
    for arch in (f"{SEAMLESS}@inhibitor", SEAMLESS):
        arm = encdec_arm(torch, kops, smi, arch)
        launches[arm["kernel"]] = arm["launches"]
    return launches


# phase 22: (arch, depth (None: full), batch, text tokens a row); the
# encoder-decoder adds ENCDEC_TRAIN_FRAMES frames a row, the vlm its
# 2,880 patch embeddings before the text.  Depth cut by memory: AdamW in
# float32 keeps 16 bytes a parameter (qwen2-moe-a2.7b at depth 2: 1.83 B,
# 29 GB; llava at depth 2: 0.70 B, 11.2 GB; seamless whole: 1.63 B, 26
# GB); hymba-1.5b by time (its Mamba branch is an eager Python loop); the
# inhibitor arm of seamless at depth 2 (its eager backward)
TRAIN_FAMILIES = [
    ("qwen2-moe-a2.7b", 2, 4, 512),
    ("hymba-1.5b", 4, 4, 256),
    (SEAMLESS, None, 4, 512),
    (VLM, 2, 2, 256),
    (f"{SEAMLESS}@inhibitor", 2, 4, 512),
]
ENCDEC_TRAIN_FRAMES = 1024
TRAIN_FAMILY_STEPS = 8
# least fall of the loss over the steps on the fixed batch (the schedule
# warms up over 10 steps: the first update has lr 0)
TRAIN_FAMILY_MIN_FALL = 0.5
# card against CPU gradients at a reduced config, float32: 1e-4 of each
# parameter's gradient norm (the CPU tests' tolerance against jax.grad)
GRAD_REL = 1e-4


def family_batch(torch, api, cfg, b: int, text: int, frames: int,
                 device: str, seed: int = 0) -> dict:
    """One training batch for ``cfg``'s family: tokens and next-token
    labels from the seeded LM stream (``lm_batch_at``); the
    encoder-decoder's frames (b, frames, embed_dim) and the vlm's patch
    embeddings from a numpy seed, the vlm's labels over image and text
    positions with the image positions at -1 (the shapes of
    ``input_specs``)."""
    import numpy as np

    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import PipelineConfig, lm_batch_at

    lm = lm_batch_at(PipelineConfig(b, text, cfg.vocab_size, seed=seed), 0)
    rng = np.random.default_rng(seed)
    out = dict(lm)
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(b, frames, cfg.frontend.embed_dim)
                                   ).astype(np.float32)
    if cfg.family == "vlm":
        fe = cfg.frontend
        n_img = fe.tokens_per_item * fe.max_tiles
        specs = api.input_specs(ShapeConfig("train", n_img + text, b,
                                            "train"))
        out["image_embeds"] = rng.normal(
            size=tuple(specs["image_embeds"].shape)).astype(np.float32)
        out["labels"] = np.concatenate(
            [np.full((b, n_img), -1, lm["labels"].dtype), lm["labels"]], 1)
        for k, spec in specs.items():
            check(tuple(out[k].shape) == tuple(spec.shape),
                  f"vlm batch {k} {out[k].shape} vs input_specs {spec}")
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def kernel_sites(cfg, batch) -> int:
    """The self-attentions of one forward the planner sends to the flash
    kernel (n_q * n_k at or above the blocked threshold)."""
    at = cfg.attention.blocked_threshold
    if cfg.family == "encdec":
        return (cfg.encdec.encoder_layers
                * (batch["frames"].shape[1] ** 2 >= at)
                + cfg.encdec.decoder_layers
                * (batch["tokens"].shape[1] ** 2 >= at))
    n = batch["tokens"].shape[1] + (batch["image_embeds"].shape[1]
                                    if "image_embeds" in batch else 0)
    return cfg.num_layers * (n * n >= at)


def grad_card_vs_cpu(torch, arch: str) -> dict:
    """One gradient of ``arch``'s reduced config (float32) on the card and
    on the CPU port, from the same parameters and batch: per parameter
    |g_card - g_cpu| within GRAD_REL of |g_cpu|; a gradient that is 0 by
    analysis (the key bias under Softmax) below 1e-6 on both, and no other
    gradient 0."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.train.step import make_grad_fn
    from repro_torch.tree import tree_leaves, tree_unflatten

    cfg = get_config(arch).reduced()
    api = get_model(cfg)
    cpu = family_params(torch, api, cfg, device="cpu")
    params = {"cpu": cpu, "cuda": tree_unflatten(
        cpu, [t.detach().to("cuda") for t in tree_leaves(cpu)])}
    frames = 24 if cfg.family == "encdec" else 0
    grads = {}
    for dev, p in params.items():
        for t in tree_leaves(p):
            t.requires_grad_(True)
        batch = family_batch(torch, api, cfg, 2, 16, frames, dev, seed=3)
        grads[dev], _ = make_grad_fn(api)(p, batch)
    # the key bias under Softmax: shift-invariant without RoPE, so its
    # gradient is 0 by analysis; no other gradient may vanish
    may_vanish = set() if cfg.attention.mechanism.startswith(
        "inhibitor") else {id(a["wk"]["bias"]) for a in attention_params(
            grads["cpu"]) if "bias" in a["wk"]}
    worst, zeros = 0.0, 0
    for g_cpu, g_card in zip(tree_leaves(grads["cpu"]),
                             tree_leaves(grads["cuda"])):
        ref = g_cpu.norm().item()
        if ref < 1e-6:
            zeros += 1
            check(id(g_cpu) in may_vanish,
                  f"{arch}: a gradient of shape {tuple(g_cpu.shape)} is 0 "
                  "on the CPU")
            check(g_card.norm().item() < 1e-6,
                  f"{arch}: a gradient 0 on the CPU is "
                  f"{g_card.norm().item()} on the card")
            continue
        worst = max(worst, (g_card.cpu() - g_cpu).norm().item() / ref)
    return {"max_rel_err": worst, "zero_leaves": zeros,
            "leaves": len(tree_leaves(grads["cpu"])), "tol": GRAD_REL,
            "ok": worst <= GRAD_REL}


def train_family_arm(torch, kops, smi: str, arch: str, depth, b: int,
                     text: int) -> dict:
    """TRAIN_FAMILY_STEPS AdamW steps (the training launcher's optimizer:
    warmup_cosine(TRAIN_LR, 10, steps)) through ``make_train_step`` on
    one fixed batch, parameters drawn on the card (``family_params``),
    remat "full".  The counts are zeroed just before the steps and read
    just after: the arm's flash kernel launched steps x kernel sites x 2
    (forward and remat recompute), every other count 0.  Every loss
    finite, the last below the first by TRAIN_FAMILY_MIN_FALL.  Printed:
    step wall p50, positions and frames a second, peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.optim import AdamWConfig, init_adamw, warmup_cosine
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch)
    if depth is not None:
        cfg = cfg.with_layers(depth)
    check(cfg.remat == "full", f"{arch}: remat {cfg.remat!r}")
    api = get_model(cfg)
    kernel = train_kernel(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = family_params(torch, api, cfg)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    opt_cfg = AdamWConfig(lr=warmup_cosine(TRAIN_LR, 10, TRAIN_FAMILY_STEPS))
    opt_state = init_adamw(params, opt_cfg)
    step_fn = make_train_step(api, opt_cfg)
    frames = ENCDEC_TRAIN_FRAMES if cfg.family == "encdec" else 0
    batch = family_batch(torch, api, cfg, b, text, frames, "cuda")
    sites = kernel_sites(cfg, batch)
    positions = b * (text + (batch["image_embeds"].shape[1]
                             if "image_embeds" in batch else 0))
    kops.reset_counts()
    losses, walls, metrics = [], [], {}
    for _ in range(TRAIN_FAMILY_STEPS):
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        walls.append(time.perf_counter() - t0)
    counts = kops.counts()
    expected = TRAIN_FAMILY_STEPS * sites * 2
    p50 = statistics.median(walls[1:])
    out = {"phase": "train_families", "arch": arch, "card": smi,
           "family": cfg.family, "layers": cfg.num_layers,
           "encdec_layers": (None if cfg.encdec is None else
                             [cfg.encdec.encoder_layers,
                              cfg.encdec.decoder_layers]),
           "params": sum(t.numel() for t in tree_leaves(params)),
           "batch": {k: list(v.shape) for k, v in batch.items()},
           "steps": TRAIN_FAMILY_STEPS, "lr": TRAIN_LR, "losses": losses,
           "metrics": {k: float(v) for k, v in metrics.items()
                       if v.numel() == 1},
           "kernel_sites": sites, "launches": counts,
           "step_wall_s": walls, "step_wall_ms_p50": p50 * 1e3,
           "positions_per_s": positions / p50,
           "frames_per_s": b * frames / p50 if frames else None,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit(out)
    check(train_launches_ok(counts, kernel, expected),
          f"{arch}: launches {counts}, expected {kernel} {expected}")
    check(all(math.isfinite(x) for x in losses), f"{arch}: losses {losses}")
    check(losses[-1] < losses[0] - TRAIN_FAMILY_MIN_FALL,
          f"{arch}: loss fell {losses[0] - losses[-1]} < "
          f"{TRAIN_FAMILY_MIN_FALL}")
    del params, opt_state, batch, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return {"kernel": kernel, "launches": counts[kernel]}


def phase_train_families(torch, kops, smi: str) -> dict:
    """Phase 22: each family's reduced gradient on the card against the
    CPU port's, then the training arms of TRAIN_FAMILIES.  Returns the
    flash kernels' launches summed over the arms."""
    grads = {arch: grad_card_vs_cpu(torch, arch)
             for arch, *_ in TRAIN_FAMILIES}
    emit({"phase": "train_families_grads", "card": smi, "grads": grads})
    for arch, g in grads.items():
        check(g["ok"], f"{arch}: card vs CPU gradients {g}")
    launches = {}
    for arch, depth, b, text in TRAIN_FAMILIES:
        arm = train_family_arm(torch, kops, smi, arch, depth, b, text)
        launches[arm["kernel"]] = (launches.get(arm["kernel"], 0)
                                   + arm["launches"])
    return launches


LANE_ARCH = "paper-tiny"
LANE_MECHS = ("inhibitor", "inhibitor_unsigned", "dotprod")
LANE_INT_SEQS = (8, 512)                   # (a): the int lane, card vs CPU
LANE_FHE_SEQS = (8, 128)                   # (b): the fhe_sim lane
LANE_TOKENS_SEED = 7
# (c): smollm-135m's attention widths, int32 q, k in [-8, 8], v in [-64, 64]
PLAN_H, PLAN_H_KV, PLAN_D, PLAN_N, PLAN_FHE_N = 9, 3, 64, 256, 32
# (c)'s forced fhe_sim check: q, k in [-2, 2] so that Z at gamma_shift 1
# leaves the inhibition live
PLAN_FHE_QK = 2
# (d): the paper's Table 3 protocol (benchmarks/table3_plaintext.py)
TABLE3_T, TABLE3_D, TABLE3_REPS = (32, 64, 128, 256), 16, 20


def lane_forward(torch, qlm, lane_name, tokens, device=None):
    """(logits on the host, wall seconds, lane) of ``qlm``'s lane forward
    on ``device`` (default: the lanes' own default, the card)."""
    from repro_torch.core.lanes import get_lane
    from repro_torch.models import transformer as tfm

    lane = get_lane(lane_name, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tfm.lm_forward_lane(qlm, lane, tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out.cpu(), wall, lane


def planner_int_checks(torch, gen) -> dict:
    """(c): the planner's ``int`` backend on the card at smollm-135m's
    attention widths, against the same call on the CPU; the ``fhe_sim``
    backend, forced without a mask, against the int lane."""
    from repro_torch.core.attention import AttentionConfig, _build_mask
    from repro_torch.core.lanes import IntLane
    from repro_torch.core.mechanism import (AttnShapes, ExecutionPlan,
                                            execute_plan, get_mechanism,
                                            plan_attention)
    from repro_torch.quant.int_attention import lane_attention_heads

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi + 1, shape, generator=gen,
                             dtype=torch.int32)

    n = PLAN_N
    q = ints(-8, 8, 1, n, PLAN_H, PLAN_D)
    k = ints(-8, 8, 1, n, PLAN_H_KV, PLAN_D)
    v = ints(-64, 64, 1, n, PLAN_H_KV, PLAN_D)
    out = {}
    for mech in LANE_MECHS:
        cfg = AttentionConfig(mechanism=mech, num_heads=PLAN_H,
                              num_kv_heads=PLAN_H_KV, head_dim=PLAN_D,
                              causal=True, use_rope=False)
        shapes = AttnShapes(1, n, n, PLAN_H, PLAN_H_KV, PLAN_D,
                            dtype=torch.int32, platform="cuda")
        plan = plan_attention(cfg, shapes)
        params = get_mechanism(mech).make_params(
            score_scale=cfg.score_scale, score_shift=cfg.score_shift,
            normalize=cfg.normalize)
        res = {}
        for key, dev in (("card", "cuda"), ("host", "cpu")):
            mask = _build_mask(cfg, n, n, 0, device=dev)
            t0 = time.perf_counter()
            res[key] = execute_plan(plan, q.to(dev), k.to(dev), v.to(dev),
                                    mask=mask, params=params)
            torch.cuda.synchronize()
            res[key + "_s"] = time.perf_counter() - t0
        r = {"plan": plan.backend, "device": res["card"].device.type,
             "dtype": str(res["card"].dtype).replace("torch.", ""),
             "bit_exact_with_cpu": bool(torch.equal(res["card"].cpu(),
                                                    res["host"])),
             "nonzero_share": float((res["host"] != 0).float().mean()),
             "wall_s": {"card": res["card_s"], "cpu": res["host_s"]}}
        # fhe_sim, forced, all-to-all at PLAN_FHE_N keys; the inhibitor
        # arms against the int backend at the (gamma, alpha) = (2^1, 1)
        # the fhe_sim backend fixes, dotprod against the int lane at the
        # fhe_sim backend's (scale_shift 2, frac_bits 4)
        m = PLAN_FHE_N
        qs = (q[:, :m] % (2 * PLAN_FHE_QK + 1) - PLAN_FHE_QK).cuda()
        ks = (k[:, :m] % (2 * PLAN_FHE_QK + 1) - PLAN_FHE_QK).cuda()
        vs = v[:, :m].cuda()
        fcfg = AttentionConfig(mechanism=mech, backend="fhe_sim",
                               num_heads=PLAN_H, num_kv_heads=PLAN_H_KV,
                               head_dim=PLAN_D, causal=False, use_rope=False)
        fplan = plan_attention(fcfg, shapes._replace(n_q=m, n_k=m))
        if mech == "dotprod":
            fparams = get_mechanism(mech).make_params()
            want = lane_attention_heads(
                IntLane(), get_mechanism(mech).lane_fn, qs, ks, vs,
                scale_shift=2, frac_bits=4)
        else:
            fparams = get_mechanism(mech).make_params(score_scale=2.0,
                                                      score_shift=1.0)
            want = execute_plan(ExecutionPlan(mech, "int", "check"), qs, ks,
                                vs, params=fparams)
        got = execute_plan(fplan, qs, ks, vs, params=fparams)
        r.update(fhe_sim_plan=fplan.backend,
                 fhe_sim_device=got.device.type,
                 fhe_sim_bit_exact_with_int=bool(torch.equal(got, want)),
                 fhe_sim_nonzero_share=float((want != 0).float().mean()))
        out[mech] = r
    return out


def table3(torch) -> dict:
    """(d): the paper's Table 3 protocol on the card — each arm's int32
    entry point (the registry's ``int_reference``) at T keys, one head,
    d 16, ms per call over TABLE3_REPS calls after warm-up."""
    from repro_torch.core.mechanism import get_mechanism

    inh = get_mechanism("inhibitor").int_reference
    dot = get_mechanism("dotprod").int_reference
    gen = torch.Generator().manual_seed(0)
    rows = {}
    for t in TABLE3_T:
        q, k, v = (torch.randint(-127, 128, (t, TABLE3_D), generator=gen,
                                 dtype=torch.int32).cuda() for _ in range(3))
        t_i = cuda_ms(lambda i: inh(q, k, v, gamma_shift=2, alpha_q=1),
                      TABLE3_REPS)
        t_d = cuda_ms(lambda i: dot(q, k, v, scale_shift=4), TABLE3_REPS)
        rows[t] = {"inhibitor_ms": t_i, "dotprod_ms": t_d,
                   "saving": 1.0 - t_i / t_d}
    return rows


def phase_lanes(torch, kops):
    """13. lanes — the integer and TFHE-simulated lanes of paper-tiny on
    the card (no kernel of this script lies on this path)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import lanes
    from repro_torch.fhe import select_params_for_report
    from repro_torch.launch.fhe import init_params
    from repro_torch.quant.ptq import ptq_lm

    lanes.reset_matmul_bound()
    kops.reset_counts()
    cfg0 = get_config(LANE_ARCH)
    params = init_params(cfg0, seed=0)
    rng = np.random.default_rng(LANE_TOKENS_SEED)
    tokens = {s: rng.integers(0, cfg0.vocab_size, (1, s))
              for s in sorted(set(LANE_INT_SEQS + LANE_FHE_SEQS))}
    out = {"phase": "lanes", "arch": LANE_ARCH, "d_model": cfg0.d_model,
           "heads": cfg0.attention.num_heads, "int": {}, "fhe_sim": {}}
    failures = []
    for mech in LANE_MECHS:
        cfg = cfg0.with_attention_kind(mech)
        qlm = ptq_lm(params, cfg)
        neg = dataclasses.replace(qlm, blocks=[
            dict(b, wv={"kernel": -b["wv"]["kernel"]}) for b in qlm.blocks])
        int_logits = {}
        for s in sorted(set(LANE_INT_SEQS + LANE_FHE_SEQS)):
            card, wall, lane = lane_forward(torch, qlm, "int", tokens[s])
            _, warm, _ = lane_forward(torch, qlm, "int", tokens[s])
            int_logits[s] = card
            r = {"device": lane.device.type, "wall_s": wall,
                 "warm_wall_s": warm,
                 "nonzero_share": float((card != 0).float().mean())}
            if s in LANE_INT_SEQS:
                cpu, cpu_wall, _ = lane_forward(torch, qlm, "int",
                                                tokens[s], device="cpu")
                ctl, _, _ = lane_forward(torch, neg, "int", tokens[s])
                r.update(bit_exact_with_cpu=bool(torch.equal(card, cpu)),
                         cpu_wall_s=cpu_wall,
                         control_differ_share=float(
                             (ctl != card).float().mean()))
                if not (r["bit_exact_with_cpu"]
                        and r["control_differ_share"] >= MIN_NONZERO_SHARE
                        and r["nonzero_share"] >= MIN_NONZERO_SHARE
                        and r["device"] == "cuda"):
                    failures.append(f"int lane {mech} seq {s}: {r}")
            out["int"][f"{mech}/{s}"] = r
        for s in LANE_FHE_SEQS:
            card, wall, lane = lane_forward(torch, qlm, "fhe_sim", tokens[s])
            _, cpu_wall, cpu_lane = lane_forward(torch, qlm, "fhe_sim",
                                                 tokens[s], device="cpu")
            report = lane.ctx.scope_report()
            tot = lane.ctx.summary()
            sel = select_params_for_report(report)
            r = {"device": lane.device.type, "wall_s": wall,
                 "cpu_wall_s": cpu_wall,
                 "bit_exact_with_int": bool(torch.equal(
                     card.to(torch.int32), int_logits[s])),
                 "report_equals_cpu": report == cpu_lane.ctx.scope_report(),
                 "totals": tot, "tfhe_params": dataclasses.asdict(sel)}
            out["fhe_sim"][f"{mech}/{s}"] = r
            cmuls_ok = ((tot["cmuls"] == 0) if mech.startswith("inhibitor")
                        else tot["cmuls"] > 0)
            if not (r["bit_exact_with_int"] and r["report_equals_cpu"]
                    and cmuls_ok and r["device"] == "cuda"):
                failures.append(f"fhe_sim lane {mech} seq {s}: {r}")
    gen = torch.Generator().manual_seed(0)
    out["planner"] = planner_int_checks(torch, gen)
    for mech, r in out["planner"].items():
        if not (r["plan"] == "int" and r["device"] == "cuda"
                and r["dtype"] == "int32" and r["bit_exact_with_cpu"]
                and r["nonzero_share"] >= MIN_NONZERO_SHARE
                and r["fhe_sim_plan"] == "fhe_sim"
                and r["fhe_sim_device"] == "cuda"
                and r["fhe_sim_bit_exact_with_int"]
                and r["fhe_sim_nonzero_share"] >= MIN_NONZERO_SHARE):
            failures.append(f"planner {mech}: {r}")
    out["table3"] = table3(torch)
    out["kernel_launches"] = kops.counts()
    stat = lanes.matmul_bound()
    out["exact_int_matmul"] = {**stat, "limit": 1 << 53,
                               "max_bound_over_limit":
                               stat["max_bound"] / (1 << 53)}
    emit(out)
    check(not failures, "lanes: " + "; ".join(failures))
    check(all(n == 0 for n in out["kernel_launches"].values()),
          f"lanes: the lanes path launched a kernel {out['kernel_launches']}")
    return out


# ---------------------------------------------------------------------------
# 14. analysis: the static FHE circuit analyzer against the fhe_sim lane
# ---------------------------------------------------------------------------

ANALYSIS_SEQS = (8, 128)
ANALYSIS_TOKEN_SEEDS = (11, 12, 13)        # and all-zero tokens
COUNTERS = ("pbs", "cmuls", "adds", "lit_muls")


def analysis_case(torch, qlm, static, tokens) -> dict:
    """One measured fhe_sim forward on the card against the static
    report: counts equal per scope, widths dominated, the cross-checked
    parameter selection passes, the static message width no smaller."""
    from repro_torch.fhe import select_params_for_report

    _, wall, lane = lane_forward(torch, qlm, "fhe_sim", tokens)
    measured = lane.ctx.scope_report()
    sp = static["per_scope"]
    r = {"device": lane.device.type, "wall_s": wall,
         "counts_equal": set(measured) == set(sp) and all(
             s[c] == sp[k][c] for k, s in measured.items()
             for c in COUNTERS),
         "dominated": all(
             s["max_bits_at_pbs"] <= sp[k]["max_bits_at_pbs"]
             and s["max_bits_any"] <= sp[k]["max_bits_any"]
             for k, s in measured.items() if k in sp),
         "max_bits_at_pbs": lane.ctx.summary()["max_bits_at_pbs"],
         "cmuls": lane.ctx.summary()["cmuls"]}
    try:
        sel = select_params_for_report(measured, static_report=sp)
        r["measured_msg_bits"] = sel.msg_bits
        r["cross_check"] = True
    except ValueError as e:
        r["cross_check"] = False
        r["error"] = str(e)
    r["ok"] = (r["device"] == "cuda" and r["counts_equal"]
               and r["dominated"] and r["cross_check"]
               and static["params"] is not None
               and static["params"]["msg_bits"] >= r["measured_msg_bits"])
    return r, measured


def soundness_control(static, measured) -> bool:
    """A static report with its worst scope lowered by one bit below the
    measured width must be refused as unsound."""
    from repro_torch.fhe import select_params_for_report

    tampered = {k: dict(v) for k, v in static["per_scope"].items()}
    worst = max(measured, key=lambda k: measured[k]["max_bits_at_pbs"])
    tampered[worst]["max_bits_at_pbs"] = \
        measured[worst]["max_bits_at_pbs"] - 1
    try:
        select_params_for_report(measured, static_report=tampered)
    except ValueError as e:
        return "SOUNDNESS" in str(e)
    return False


def phase_analysis(torch, kops):
    """14. analysis — the static analyzer's proof on paper-tiny (host),
    held against the measured fhe_sim forward on the card."""
    import io

    import numpy as np

    from repro_torch.analysis import analyze_qlm
    from repro_torch.analysis.__main__ import main as analysis_main
    from repro_torch.configs import get_config
    from repro_torch.launch.fhe import init_params
    from repro_torch.quant.ptq import ptq_lm

    kops.reset_counts()
    cfg0 = get_config(LANE_ARCH)
    params = init_params(cfg0, seed=0)
    out = {"phase": "analysis", "arch": LANE_ARCH, "d_model": cfg0.d_model,
           "seqs": list(ANALYSIS_SEQS),
           "token_seeds": list(ANALYSIS_TOKEN_SEEDS) + ["zeros"],
           "arms": {}}
    failures = []
    for mech in LANE_MECHS:
        qlm = ptq_lm(params, cfg0.with_attention_kind(mech))
        for s in ANALYSIS_SEQS:
            t0 = time.perf_counter()
            static = analyze_qlm(qlm, seq_len=s)
            static_s = time.perf_counter() - t0
            inputs = {f"seed {seed}": np.random.default_rng(seed).integers(
                0, cfg0.vocab_size, (1, s)) for seed in ANALYSIS_TOKEN_SEEDS}
            inputs["zeros"] = np.zeros((1, s), np.int64)
            cases = {}
            for label, toks in inputs.items():
                cases[label], measured = analysis_case(torch, qlm, static,
                                                       toks)
            cmul_scopes = sorted({c["scope"] for c in static["cmul_sites"]})
            r = {"static_wall_s": static_s,
                 "static_max_bits_at_pbs":
                     static["totals"]["max_bits_at_pbs"],
                 "static_params": static["params"],
                 "zero_cmul_proven": static["zero_cmul_proven"],
                 "cmul_scopes": cmul_scopes,
                 "lut_verified": static["lut_verification"]["verified"],
                 "lut_saturating": static["lut_verification"][
                     "n_saturating"],
                 "soundness_control_refused": soundness_control(static,
                                                                measured),
                 "measured": cases}
            arm_ok = (r["lut_verified"] and r["soundness_control_refused"]
                      and all(c["ok"] for c in cases.values()))
            if mech.startswith("inhibitor"):
                arm_ok &= r["zero_cmul_proven"] and all(
                    c["cmuls"] == 0 for c in cases.values())
            else:
                arm_ok &= cmul_scopes == ["L0.attn"]
            if not arm_ok:
                failures.append(f"{mech} seq {s}: {r}")
            out["arms"][f"{mech}/{s}"] = r
    # the CLI, as a user runs it: its own seeded init, both default arms
    path = Path(__file__).resolve().parent / "build" / "ANALYSIS_fhe.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = analysis_main(["--out", str(path)])
    out["cli"] = {"rc": rc, "wall_s": time.perf_counter() - t0,
                  "out": str(path.relative_to(path.parents[1])),
                  "mechanisms": sorted(json.loads(path.read_text())[
                      "mechanisms"])}
    out["kernel_launches"] = kops.counts()
    emit(out)
    check(not failures, "analysis: " + "; ".join(failures))
    check(rc == 0, f"analysis: the CLI exited {rc}:\n{log.getvalue()}")
    check(all(n == 0 for n in out["kernel_launches"].values()),
          f"analysis: a kernel launched {out['kernel_launches']}")
    return out


# ---------------------------------------------------------------------------
# 15. resume: checkpoint, resume and remat "dots" at full width
# ---------------------------------------------------------------------------

# (arch, depth): the dot-product arm at full depth, the inhibitor arm at 2
RESUME_ARMS = (("smollm-135m", None), ("smollm-135m@inhibitor", 2))
RESUME_STEPS, RESUME_CUT, RESUME_EVERY = 8, 6, 4
# tests/test_train_loop.py::test_checkpoint_resume_exact's tolerance
RESUME_RTOL, RESUME_ATOL = 1e-5, 1e-6
# remat "dots" against "full": max over parameters of |g_dots - g_full| /
# max |g_full| (the same operations on the same inputs; the saved matmul
# outputs are the ones "full" recomputes)
REMAT_TOL = 1e-5
REMAT_REPS = 3


def state_diff(ref, got) -> dict:
    """The largest |got - ref| over the leaves, and whether every element
    is within RESUME_ATOL + RESUME_RTOL |ref| (assert_allclose's rule)."""
    max_abs, excess = 0.0, -math.inf
    for a, b in zip(ref, got):
        a, b = a.detach().double(), b.detach().double()
        d = (b - a).abs()
        max_abs = max(max_abs, d.max().item())
        excess = max(excess, (d - RESUME_ATOL - RESUME_RTOL * a.abs())
                     .max().item())
    return {"max_abs_diff": max_abs, "ok": excess <= 0.0}


@contextlib.contextmanager
def timed_store(store, log: dict):
    """Record the seconds of every checkpoint write and read."""
    real = {name: getattr(store, name) for name in ("save", "restore")}

    def wrap(name):
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return real[name](*a, **k)
            finally:
                log.setdefault(name + "_s", []).append(
                    time.perf_counter() - t0)
        return timed

    for name in real:
        setattr(store, name, wrap(name))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(store, name, fn)


def resume_arm(torch, kops, arch: str, depth) -> dict:
    """Uninterrupted runs against a run cut at RESUME_CUT (async commits
    every RESUME_EVERY steps) and resumed to RESUME_STEPS."""
    from repro_torch.checkpoint import (CheckpointConfig, committed_steps,
                                        store)
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, lm_batch_at
    from repro_torch.models.registry import get_model
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.train.loop import TrainConfig, train
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch)
    if depth:
        cfg = cfg.with_layers(depth)
    api = get_model(cfg)
    pipe = PipelineConfig(TRAIN_B, TRAIN_N, cfg.vocab_size, seed=0)
    opt = AdamWConfig(lr=warmup_cosine(TRAIN_LR, 10, RESUME_STEPS))
    steps_run = [0]

    def run(total, ck=None):
        t0 = time.perf_counter()
        r = train(api, opt, TrainConfig(total_steps=total, seed=0,
                                        checkpoint=ck),
                  lambda step: lm_batch_at(pipe, step), device="cuda")
        torch.cuda.synchronize()
        steps_run[0] += len(r["history"])
        return r, time.perf_counter() - t0

    def leaves(r):
        return tree_leaves((r["params"], r["opt_state"]))

    kernel = train_kernel(cfg)
    out = {"arch": arch, "kernel": kernel, "layers": cfg.num_layers,
           "steps": RESUME_STEPS, "cut": RESUME_CUT, "every": RESUME_EVERY,
           "rtol": RESUME_RTOL, "atol": RESUME_ATOL}
    kops.reset_counts()
    a, out["uninterrupted_s"] = run(RESUME_STEPS)
    ref = [x.detach().clone() for x in leaves(a)]
    del a
    b, _ = run(RESUME_STEPS)
    out["two_uninterrupted"] = state_diff(ref, leaves(b))
    del b
    io_log = {}
    with tempfile.TemporaryDirectory() as root, timed_store(store, io_log):
        ck = CheckpointConfig(root, every_steps=RESUME_EVERY, keep=2,
                              async_save=True)
        c, out["cut_s"] = run(RESUME_CUT, ck)
        out["committed_after_cut"] = committed_steps(root)
        del c
        d, out["resumed_s"] = run(RESUME_STEPS, ck)
        out["resumed_from"] = d["history"][0]["step"]
        out["committed_after_resume"] = committed_steps(root)
        out["resumed_vs_uninterrupted"] = state_diff(ref, leaves(d))
        last = Path(root) / f"step_{RESUME_STEPS:08d}"
        out["checkpoint_bytes"] = sum(f.stat().st_size
                                      for f in last.iterdir())
        del d
    out.update(io_log)
    del ref
    torch.cuda.empty_cache()
    counts = kops.counts()
    out["launches"] = counts
    out["steps_run"] = steps_run[0]
    expected = steps_run[0] * cfg.num_layers * 2
    out["ok"] = (out["two_uninterrupted"]["ok"]
                 and out["resumed_vs_uninterrupted"]["ok"]
                 and out["committed_after_cut"] == [RESUME_EVERY,
                                                    RESUME_CUT]
                 and out["committed_after_resume"] == [RESUME_CUT,
                                                       RESUME_STEPS]
                 and out["resumed_from"] == RESUME_CUT
                 and train_launches_ok(counts, kernel, expected))
    return out


def remat_arm(torch, kops, arch: str) -> dict:
    """Remat "dots" against "full" at depth 2: one batch TRAIN_B x
    TRAIN_N, the same parameters; gradients, step walls, peak memory."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, lm_batch_at
    from repro_torch.models.registry import get_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.step import init_train_state, make_grad_fn
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch).with_layers(2)
    batch = {k: torch.from_numpy(v).cuda() for k, v in lm_batch_at(
        PipelineConfig(TRAIN_B, TRAIN_N, cfg.vocab_size, seed=0), 0).items()}
    kernel = train_kernel(cfg)
    out, grads = {"arch": arch, "layers": 2, "reps": REMAT_REPS}, {}
    for remat in ("full", "dots"):
        api = get_model(dataclasses.replace(cfg, remat=remat))
        params, _ = init_train_state(
            api, AdamWConfig(), torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
        grad_fn = make_grad_fn(api)
        grad_fn(params, batch)                    # warm-up
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kops.reset_counts()
        walls = []
        for _ in range(REMAT_REPS):
            t0 = time.perf_counter()
            g, _ = grad_fn(params, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        counts = kops.counts()
        grads[remat] = tree_leaves(g)
        out[remat] = {"grad_wall_ms": [w * 1e3 for w in walls],
                      "grad_wall_ms_p50": statistics.median(walls) * 1e3,
                      "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                      "launches": counts,
                      "launches_ok": train_launches_ok(
                          counts, kernel, REMAT_REPS * 2 * 2)}
        del params, g
    rel = max(((a.float() - b.float()).abs().max()
               / a.float().abs().max().clamp_min(1e-30)).item()
              for a, b in zip(grads["full"], grads["dots"]))
    out["dots_vs_full_rel"] = rel
    out["tol"] = REMAT_TOL
    out["ok"] = (rel <= REMAT_TOL and out["full"]["launches_ok"]
                 and out["dots"]["launches_ok"])
    del grads
    torch.cuda.empty_cache()
    return out


def phase_resume(torch, kops):
    """15. resume — checkpoint and resume through the training loop at
    full width, and remat "dots" against "full"."""
    out = {"phase": "resume", "arms": {}, "remat": {}}
    for arch, depth in RESUME_ARMS:
        out["arms"][arch] = resume_arm(torch, kops, arch, depth)
    for arch, _ in RESUME_ARMS:
        out["remat"][arch] = remat_arm(torch, kops, arch)
    emit(out)
    for name, r in list(out["arms"].items()) + list(out["remat"].items()):
        check(r["ok"], f"resume: {name}: {r}")
    return {r["kernel"]: r["launches"][r["kernel"]]
            for r in out["arms"].values()}


DIST_ARMS = (("smollm-135m", None), ("smollm-135m@inhibitor", 2))
#: the RWKV-6 and Mamba mixers split over ``model``: (arch, depth, batch,
#: seq) at full width; rwkv6-7b through the WKV kernel at the train
#: phase's batch, hymba-1.5b at phase 22's (its Mamba branch is an eager
#: Python loop over time)
DIST_MIXER_ARMS = (("rwkv6-7b", 2, 8, 1024), ("hymba-1.5b", 2, 4, 256))
DIST_STEPS = 4
#: sharded vs unsharded, each parameter leaf and each loss: |a - b| within
#: DIST_REL of the leaf's largest |b| (expected: equal up to float32
#: rounding at mesh size 1, where every gather is a no-op)
DIST_REL = 1e-5
DIST_PRED_S = 150.0                         # the phase's predicted wall
#: the error-feedback residual's bound, in scales: 1/2, plus the float32
#: rounding of the division and the subtraction (2 · 127 · 2^-24)
COMPRESS_RESID = 0.5 + 2 * 127 * 2.0 ** -24
DRYRUN_CELL = ("smollm-135m", "decode_32k")


def split_layers(dparams, mesh, cfg) -> dict:
    """The layers the sharded steps hand split over ``model``
    (``ModelShards``), counted by kind: what shows that the
    tensor-parallel path runs on this mesh."""
    import torch

    from repro_torch.distributed.sharding import is_split
    from repro_torch.launch import shardings as shlib

    counts = {}

    def kind_of(node, key):
        for name, kind in (("wq", "attention"), ("router", "moe"),
                           ("table", "embedding"), ("ln_x", "time_mix"),
                           ("mu_k", "channel_mix"), ("A_log", "mamba")):
            if name in node:
                return kind
        return "head" if key == "lm_head" else "mlp"

    def walk(node, key=None):
        if is_split(node):
            kind = kind_of(node, key)
            counts[kind] = counts.get(kind, 0) + 1
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    with torch.no_grad():
        walk(shlib.gather_params(dparams, mesh, grad=False, cfg=cfg))
    return counts


def split_layers_expected(cfg) -> dict:
    """Every layer of ``cfg`` split at one ``model`` rank (where every dim
    divides): the RWKV-6 mixers, or the attention, the MLP and (hybrid)
    the Mamba branch, in every block; the embedding, and the head where
    it is not tied."""
    n = cfg.num_layers
    want = ({"time_mix": n, "channel_mix": n} if cfg.family == "ssm"
            else {"attention": n, "mlp": n})
    if cfg.family == "hybrid":
        want["mamba"] = n
    want["embedding"] = 1
    if not cfg.tie_embeddings:
        want["head"] = 1
    return want


def leaf_rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / max(float(b.float().abs().max()), 1e-30))


def dist_arm(torch, kops, mesh, arch: str, depth, b: int = TRAIN_B,
             n: int = TRAIN_N) -> dict:
    """DIST_STEPS AdamW steps of one fixed batch b x n (default TRAIN_B x
    TRAIN_N) of the seeded LM stream (remat "full"), unsharded
    (``make_train_step``) and through the sharded step on the one-rank
    mesh, from the same parameters: every layer handed split; losses and
    every parameter within DIST_REL; the arm's kernel (the flash kernel
    of its attention where the planner sends it there, the WKV kernel of
    the RWKV-6 family) launched steps x kernel sites x 2 (forward and
    recompute) times in the sharded run, no other kernel and no plain
    version; a perturbed shard outside DIST_REL."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, lm_batch_at
    from repro_torch.launch import shardings as shlib
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import box_like
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map

    cfg = get_config(arch)
    if depth:
        cfg = cfg.with_layers(depth)
    check(cfg.remat == "full", f"{arch}: remat is {cfg.remat!r}")
    api = get_model(cfg)
    opt = AdamWConfig(lr=TRAIN_LR)
    batch = {k: torch.from_numpy(v).cuda() for k, v in lm_batch_at(
        PipelineConfig(b, n, cfg.vocab_size, seed=0), 0).items()}
    if cfg.family == "ssm":
        kernel, sites = "wkv6", cfg.num_layers
    else:
        kernel, sites = train_kernel(cfg), kernel_sites(cfg, batch)
    out = {"arch": arch, "layers": cfg.num_layers, "steps": DIST_STEPS,
           "batch": [b, n], "kernel": kernel, "rel": DIST_REL}

    def init():
        return init_train_state(api, opt, torch.Generator(
            device="cuda").manual_seed(0), device="cuda")

    def run(step, params, state, b):
        losses, walls, dev = [], [], []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(DIST_STEPS):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            params, state, m = step(params, state, b)
            e1.record()
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            dev.append(e0.elapsed_time(e1))
        return params, losses, {
            # the first step pays the process's first kernel calls
            "step_wall_ms_p50": statistics.median(walls[1:]) * 1e3,
            "step_wall_ms": [w * 1e3 for w in walls],
            "step_device_ms": dev,
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}

    params, state = init()
    ref_params, ref_losses, out["unsharded"] = run(
        make_train_step(api, opt), params, state, batch)
    ref = [p.detach().clone() for p in tree_leaves(ref_params)]
    ref_tree = tree_map(lambda p: 0, ref_params)
    del params, state, ref_params
    torch.cuda.empty_cache()

    params, state = init()
    _, psh = shlib.params_shardings(box_like(params, api.axes()), mesh)
    dparams = shlib.place(params, psh, requires_grad=True)
    dstate = shlib.place(state, shlib.opt_shardings(state, psh, mesh))
    dbatch = shlib.place(batch, shlib.batch_shardings(batch, mesh))
    del params, state
    out["split_layers"] = split_layers(dparams, mesh, cfg)
    torch.cuda.empty_cache()
    kops.reset_counts()
    # at one ``model`` rank no attention splits its query rows: offset 0,
    # the training entry, never the cursor-carrying cached one
    cached = []
    with recording(kops, "flash_inhibitor_cached", cached), \
            recording(kops, "flash_attention_cached", cached):
        dparams, losses, out["sharded"] = run(
            shlib.make_sharded_train_step(api, opt, mesh), dparams, dstate,
            dbatch)
    counts = kops.counts()
    out["cached_entry_calls"] = len(cached)
    check(not cached, f"{arch}: the sharded step reached a cached flash "
          f"entry {len(cached)} times")
    got = [shlib.local(p).detach() for p in tree_leaves(dparams)]
    out["losses"] = losses
    out["unsharded_losses"] = ref_losses
    out["loss_rel"] = max(abs(a - b) / max(abs(b), 1e-30)
                          for a, b in zip(losses, ref_losses))
    rels = [leaf_rel(a, b) for a, b in zip(got, ref)]
    out["param_rel_max"] = max(rels)
    worst = max(range(len(rels)), key=rels.__getitem__)
    out["param_rel_worst_leaf"] = "/".join(
        str(k) for k in tree_flatten_with_path(ref_tree)[worst][0])
    # the control: one shard perturbed by 1e-3 of its scale
    bad = got[0].clone()
    bad.view(-1)[0] += 1e-3 * float(bad.abs().max())
    out["control_rel"] = leaf_rel(bad, ref[0])
    out["launches"] = counts
    expected = DIST_STEPS * sites * 2
    out["wall_ratio"] = (out["sharded"]["step_wall_ms_p50"]
                         / out["unsharded"]["step_wall_ms_p50"])
    emit({"phase": "distributed", "arm": out})
    emit({"phase": "distributed", "split_path": {
        "arch": arch, "split_layers": out["split_layers"],
        "loss_rel": out["loss_rel"], "param_rel_max": out["param_rel_max"],
        "bound": DIST_REL, "wall_ratio": out["wall_ratio"],
        "peak_memory_bytes": {"sharded": out["sharded"]["peak_memory_bytes"],
                              "unsharded": out["unsharded"][
                                  "peak_memory_bytes"]}}})
    want = split_layers_expected(cfg)
    check(out["split_layers"] == want, f"{arch}: the tensor-parallel path "
          f"was not taken: split {out['split_layers']}, expected {want}")
    check(out["loss_rel"] <= DIST_REL, f"{arch}: sharded losses {losses} "
          f"vs {ref_losses}")
    check(out["param_rel_max"] <= DIST_REL,
          f"{arch}: sharded parameters off by {out['param_rel_max']}")
    check(out["control_rel"] > DIST_REL, f"{arch}: control not caught")
    check(train_launches_ok(counts, kernel, expected),
          f"{arch}: launches {counts}, expected {kernel} {expected}")
    del dparams, dstate, got, ref
    gc.collect()
    torch.cuda.empty_cache()
    return {"kernel": kernel, "launches": counts[kernel], "api": api,
            "batch": batch}


def dist_compress(torch, api, batch) -> dict:
    """compress_tree / decompress_tree on the full-width gradient tree of
    the dot-product arm, card against the CPU port on the same inputs:
    bit-equal payloads, scales and residuals; each residual within
    COMPRESS_RESID scales."""
    from repro_torch.optim import compress_tree, decompress_tree
    from repro_torch.optim.compress import init_compression
    from repro_torch.train.step import init_train_state, make_grad_fn
    from repro_torch.optim import AdamWConfig
    from repro_torch.tree import tree_leaves, tree_map

    params, _ = init_train_state(api, AdamWConfig(), torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    grads, _ = make_grad_fn(api)(params, batch)
    del params
    state = init_compression(grads)
    t0 = time.perf_counter()
    (q, s), new = compress_tree(grads, state)
    deq = decompress_tree(q, s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cpu = tree_map(lambda g: g.detach().cpu(), grads)
    (qc, sc), newc = compress_tree(cpu, init_compression(cpu))
    deqc = decompress_tree(qc, sc)
    equal = all(torch.equal(a.cpu(), b) for a, b in zip(
        tree_leaves((q, s, new.error, deq)),
        tree_leaves((qc, sc, newc.error, deqc))))
    resid = max(float((e.abs() / sc_).max()) for e, sc_ in zip(
        tree_leaves(new.error), tree_leaves(s)))
    out = {"leaves": len(tree_leaves(grads)),
           "elements": sum(g.numel() for g in tree_leaves(grads)),
           "bit_equal_to_cpu": equal, "residual_over_scale_max": resid,
           "wall_s": wall}
    emit({"phase": "distributed", "compress": out})
    check(equal, "compress_tree: card differs from the CPU")
    check(resid <= COMPRESS_RESID, f"compress residual {resid} scales")
    return out


def dist_collectives(torch) -> dict:
    """compressed_grad_sync, allgather_matmul and pipeline_apply on
    one-rank NCCL meshes (the ring and pipe sends go to the rank itself):
    the sync bit-equal to the CPU's formula; the matmul and the schedule
    equal to the card's own products and within GRAD_REL of the CPU's."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.collectives import (allgather_matmul,
                                                     compressed_grad_sync)
    from repro_torch.distributed.pipeline import make_pp_mesh, pipeline_apply
    from repro_torch.optim.compress import compress, divide

    gen = torch.Generator().manual_seed(0)
    g = {"a": torch.randn(4096, generator=gen),
         "b": torch.randn(64, 33, generator=gen)}
    mesh3 = init_device_mesh("cuda", (1, 1, 1),
                             mesh_dim_names=("pod", "data", "model"))
    got = compressed_grad_sync({k: v.cuda() for k, v in g.items()}, mesh3)

    def cpu_sync(x):
        # one rank: the data mean and the pod sum are x itself
        q, scale, _ = compress(x, torch.zeros_like(x))
        return q.to(torch.int32).float() * divide(scale, 1)

    sync_equal = all(torch.equal(got[k].cpu(), cpu_sync(g[k])) for k in g)
    mmesh = init_device_mesh("cuda", (1,), mesh_dim_names=("model",))
    x = torch.randn(256, 512, generator=gen)
    w = torch.randn(512, 384, generator=gen)
    y = allgather_matmul(x.cuda(), w.cuda(), mmesh)
    # one hop: the product of the resident chunk, added to zeros; on the
    # card that is the card's own product exactly, and the CPU's within
    # the float32 products' summation order (GRAD_REL, as phase 22)
    mm_card_equal = bool(torch.equal(y, x.cuda() @ w.cuda()))
    mm_rel = leaf_rel(y.cpu(), x @ w)
    pmesh = make_pp_mesh(1, device_type="cuda")
    S, M, mb, dim = 1, 8, 4, 256
    ws = torch.randn(S, dim, dim, generator=gen) * dim ** -0.5
    xs = torch.randn(M, mb, dim, generator=gen)
    yp = pipeline_apply(lambda wt, v: torch.tanh(v @ wt), ws.cuda(),
                        xs.cuda(), pmesh, num_microbatches=M)
    # the stages in sequence, one microbatch at a time as the schedule
    # applies them: on the card exactly, on the CPU within GRAD_REL
    seq_card = torch.stack([torch.tanh(xs[m].cuda() @ ws[0].cuda())
                            for m in range(M)])
    pp_card_equal = bool(torch.equal(yp, seq_card))
    ref = xs
    for s_ in range(S):
        ref = torch.tanh(ref @ ws[s_])
    pp_rel = leaf_rel(yp.cpu(), ref)
    out = {"compressed_grad_sync_equal": sync_equal,
           "allgather_matmul_equal_on_card": mm_card_equal,
           "allgather_matmul_rel_cpu": mm_rel,
           "pipeline_apply_equal_on_card": pp_card_equal,
           "pipeline_apply_rel_cpu": pp_rel, "rel_cpu": GRAD_REL}
    emit({"phase": "distributed", "collectives": out})
    check(sync_equal, "compressed_grad_sync: card differs from the CPU")
    check(mm_card_equal and mm_rel <= GRAD_REL,
          f"allgather_matmul: {out}")
    check(pp_card_equal and pp_rel <= GRAD_REL, f"pipeline_apply: {out}")
    return out


def dist_dryrun() -> dict:
    """The dry-run CLI on DRYRUN_CELL, multi-pod, host only (a fake
    process group of 512 ranks, no card): rc 0, "[OK]", its record."""
    arch, shape = DRYRUN_CELL
    out_dir = SRC.parent / "build" / "dryrun"
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--multi-pod", "--out-dir", str(out_dir)],
        env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    path = out_dir / f"{arch}_{shape}_2x16x16.json"
    rec = json.loads(path.read_text()) if path.exists() else None
    per_rank = None if rec is None or not rec.get("ok") else {
        "flops": rec["cost_raw"]["flops"],
        "all_reduces": rec["collectives"]["counts"]["all-reduce"]}
    emit({"phase": "distributed", "dryrun": {"rc": r.returncode,
                                             "wall_s": wall,
                                             "stdout": r.stdout[-400:],
                                             "per_rank": per_rank,
                                             "record": rec}})
    emit({"phase": "distributed", "dryrun_per_rank": {
        "cell": [arch, shape, "2x16x16"], **(per_rank or {})}})
    check(r.returncode == 0 and "[OK]" in r.stdout and rec
          and rec.get("ok"), f"dry-run failed: {r.stderr[-2000:]}")
    return rec


#: the microbatched MoE sharded step: (arch, depth, batch, seq), its
#: microbatches and AdamW steps; sharded against unsharded, each loss and
#: parameter leaf within DIST_MOE_REL of the unsharded one's (expected
#: equal: at one batch rank the global re-split is the identity and the
#: MoE layer takes its one-process arithmetic)
DIST_MOE = ("qwen2-moe-a2.7b", 2, 4, 1024)
DIST_MOE_MB, DIST_MOE_STEPS = 4, 2
DIST_MOE_REL = 1e-6


def dist_resume_arm(torch, kops, mesh, arch: str, depth) -> dict:
    """``train()`` under the mesh with checkpoints, at phase 15's steps,
    cut and cadence: RESUME_STEPS steps uninterrupted (async commits
    every RESUME_EVERY, keep 2), then the same run cut at RESUME_CUT and
    resumed.  Held: losses,
    parameters and moments of the resumed run equal to the uninterrupted
    run's (0.0), its leaves DTensors with the uninterrupted run's
    placements; the last commit restored in this process without a mesh
    onto the card equal to the gathered state; the card's memory during
    a save of the live state at most one leaf above its level before;
    the arm's flash kernel launched steps run x layers x 2 times, the
    rest never."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import (CheckpointConfig, CheckpointManager,
                                        committed_steps, store)
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, lm_batch_at
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.shardings import local
    from repro_torch.models.registry import get_model
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.train.loop import TrainConfig, train
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch)
    if depth:
        cfg = cfg.with_layers(depth)
    api = get_model(cfg)
    pipe = PipelineConfig(TRAIN_B, TRAIN_N, cfg.vocab_size, seed=0)
    opt = AdamWConfig(lr=warmup_cosine(TRAIN_LR, 10, RESUME_STEPS))
    kernel = train_kernel(cfg)
    steps_run = [0]

    def run(total, root):
        ck = CheckpointConfig(root, every_steps=RESUME_EVERY, keep=2,
                              async_save=True)
        t0 = time.perf_counter()
        with use_mesh(mesh):
            r = train(api, opt, TrainConfig(total_steps=total, seed=0,
                                            checkpoint=ck),
                      lambda step: lm_batch_at(pipe, step), device="cuda")
        torch.cuda.synchronize()
        steps_run[0] += len(r["history"])
        return r, time.perf_counter() - t0

    def state(r):
        return tree_leaves((r["params"], r["opt_state"]))

    out = {"arch": arch, "kernel": kernel, "layers": cfg.num_layers,
           "steps": RESUME_STEPS, "cut": RESUME_CUT,
           "every": RESUME_EVERY, "batch": [TRAIN_B, TRAIN_N]}
    io_log = {}
    kops.reset_counts()
    with tempfile.TemporaryDirectory() as tmp, timed_store(store, io_log):
        a, out["uninterrupted_s"] = run(RESUME_STEPS, f"{tmp}/full")
        live = state(a)
        ref = [local(x).detach().clone() for x in live]
        ref_placements = [tuple(x.placements) for x in live]
        ref_losses = [h["loss"] for h in a["history"]]
        # one save of the live state, timed, and the card's memory over
        # it against its level before (the writer is rank 0 here)
        mgr = CheckpointManager(CheckpointConfig(f"{tmp}/save",
                                                 async_save=False),
                                mesh=mesh)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mgr.save(RESUME_STEPS, (a["params"], a["opt_state"]))
        out["live_save_s"] = time.perf_counter() - t0
        out["save_peak_growth_bytes"] = torch.cuda.max_memory_allocated() - base
        out["largest_leaf_bytes"] = max(x.numel() * x.element_size()
                                        for x in live)
        del a, live, mgr
        c, out["cut_s"] = run(RESUME_CUT, f"{tmp}/cut")
        out["committed_after_cut"] = committed_steps(f"{tmp}/cut")
        del c
        d, out["resumed_s"] = run(RESUME_STEPS, f"{tmp}/cut")
        out["resumed_from"] = d["history"][0]["step"]
        out["committed_after_resume"] = committed_steps(f"{tmp}/cut")
        got = state(d)
        out["losses"] = ref_losses
        out["resumed_losses"] = [h["loss"] for h in d["history"]]
        out["resumed_vs_uninterrupted_max_abs"] = max(
            float((local(x).detach().double() - r.double()).abs().max())
            for x, r in zip(got, ref))
        out["dtensor_placements_equal"] = all(
            isinstance(x, DTensor) and tuple(x.placements) == p
            for x, p in zip(got, ref_placements))
        out["params_require_grad"] = all(
            p.requires_grad for p in tree_leaves(d["params"]))
        last = Path(tmp) / "cut" / f"step_{RESUME_STEPS:08d}"
        out["checkpoint_bytes"] = sum(f.stat().st_size
                                      for f in last.iterdir())
        t0 = time.perf_counter()
        plain, step = store.restore(f"{tmp}/cut", (d["params"],
                                                   d["opt_state"]),
                                    device="cuda")
        out["in_process_restore_s"] = time.perf_counter() - t0
        out["in_process_restore_equal"] = step == RESUME_STEPS and all(
            not isinstance(p, DTensor) and p.device.type == "cuda"
            and torch.equal(p, x.detach().full_tensor())
            for p, x in zip(tree_leaves(plain), got))
        del d, got, plain, ref
    counts = kops.counts()
    out.update(io_log)
    out["launches"] = counts
    out["steps_run"] = steps_run[0]
    expected = steps_run[0] * cfg.num_layers * 2
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "distributed", "resume": out})
    check(out["resumed_losses"] == ref_losses[RESUME_CUT:],
          f"{arch}: resumed losses {out['resumed_losses']} vs "
          f"{ref_losses}")
    check(out["resumed_vs_uninterrupted_max_abs"] == 0.0,
          f"{arch}: resumed state off by "
          f"{out['resumed_vs_uninterrupted_max_abs']}")
    check(out["dtensor_placements_equal"] and out["params_require_grad"],
          f"{arch}: resumed leaves not the fresh placement")
    check(out["in_process_restore_equal"],
          f"{arch}: the commit restored without a mesh differs")
    check(out["committed_after_cut"] == [RESUME_EVERY, RESUME_CUT]
          and out["committed_after_resume"] == [RESUME_CUT,
                                                RESUME_STEPS]
          and out["resumed_from"] == RESUME_CUT,
          f"{arch}: commits {out['committed_after_cut']} / "
          f"{out['committed_after_resume']}, resumed from "
          f"{out['resumed_from']}")
    check(out["save_peak_growth_bytes"] <= out["largest_leaf_bytes"],
          f"{arch}: a save grew the card's memory by "
          f"{out['save_peak_growth_bytes']} bytes")
    check(train_launches_ok(counts, kernel, expected),
          f"{arch}: launches {counts}, expected {kernel} {expected}")
    return {"kernel": kernel, "launches": counts[kernel]}


def dist_moe_microbatched(torch, kops, mesh) -> dict:
    """DIST_MOE at DIST_MOE_MB microbatches, DIST_MOE_STEPS AdamW steps of
    one batch: the sharded step on the mesh, its results kept on the
    host and the card freed, then the unsharded ``make_train_step`` from
    the same parameters.  Held: losses and every parameter within
    DIST_MOE_REL; ``flash_attention`` launched steps x microbatches x
    layers x 2 times in each run, every other count 0.  Printed: the MoE
    layer's dropped fraction in each forward of the sharded run."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import is_split
    from repro_torch.launch import shardings as shlib
    from repro_torch.models.registry import get_model
    from repro_torch.nn import moe
    from repro_torch.nn.module import box_like
    from repro_torch.optim import AdamWConfig, init_adamw
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_leaves

    arch, depth, b, n = DIST_MOE
    cfg = get_config(arch).with_layers(depth)
    check(cfg.remat == "full", f"{arch}: remat is {cfg.remat!r}")
    api = get_model(cfg)
    opt = AdamWConfig(lr=TRAIN_LR)
    kernel = train_kernel(cfg)
    out = {"arch": arch, "layers": depth, "batch": [b, n],
           "microbatches": DIST_MOE_MB, "steps": DIST_MOE_STEPS,
           "kernel": kernel, "rel": DIST_MOE_REL}
    expected = DIST_MOE_STEPS * DIST_MOE_MB * depth * 2

    def params():
        p = family_params(torch, api, cfg)
        for t in tree_leaves(p):
            t.requires_grad_(True)
        return p

    def steps(step_fn, p, state, batch):
        losses, walls = [], []
        torch.cuda.reset_peak_memory_stats()
        kops.reset_counts()
        for _ in range(DIST_MOE_STEPS):
            t0 = time.perf_counter()
            p, state, m = step_fn(p, state, batch)
            losses.append(float(m["loss"]))
            walls.append(time.perf_counter() - t0)
        return p, losses, {"step_wall_ms": [w * 1e3 for w in walls],
                           "peak_memory_bytes":
                           torch.cuda.max_memory_allocated(),
                           "launches": kops.counts()}

    batch = family_batch(torch, api, cfg, b, n, 0, "cuda")
    p = params()
    state = init_adamw(p, opt)
    _, psh = shlib.params_shardings(box_like(p, api.axes()), mesh)
    dp = shlib.place(p, psh, requires_grad=True)
    ds = shlib.place(state, shlib.opt_shardings(state, psh, mesh))
    db = shlib.place(batch, shlib.batch_shardings(batch, mesh))
    del p, state
    torch.cuda.empty_cache()
    # the dropped fraction of every MoE call (the recomputes included);
    # the layer's output is not kept, which would hold its graph
    dropped, orig = [], moe.apply_moe

    split_calls = []

    def counted(*a, **kw):
        y, aux = orig(*a, **kw)
        dropped.append(aux.dropped_fraction.detach())
        split_calls.append(is_split(a[0]))
        return y, aux

    moe.apply_moe = counted
    try:
        dp, losses, out["sharded"] = steps(shlib.make_sharded_train_step(
            api, opt, mesh, DIST_MOE_MB), dp, ds, db)
    finally:
        moe.apply_moe = orig
    out["dropped_fraction"] = [float(x) for x in dropped]
    out["split_moe_calls"] = [sum(split_calls), len(split_calls)]
    host = [shlib.local(x).detach().cpu() for x in tree_leaves(dp)]
    del dp, ds, db, dropped
    gc.collect()
    torch.cuda.empty_cache()

    p = params()
    p, ref_losses, out["unsharded"] = steps(
        make_train_step(api, opt, DIST_MOE_MB), p, init_adamw(p, opt), batch)
    out["losses"], out["unsharded_losses"] = losses, ref_losses
    out["loss_rel"] = max(abs(a - b) / max(abs(b), 1e-30)
                          for a, b in zip(losses, ref_losses))
    out["param_rel_max"] = max(leaf_rel(h, x.detach().cpu())
                               for h, x in zip(host, tree_leaves(p)))
    del p, host, batch
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "distributed", "moe_microbatched": out})
    emit({"phase": "distributed", "split_path": {
        "arch": arch, "microbatches": DIST_MOE_MB,
        "split_moe_calls": out["split_moe_calls"],
        "loss_rel": out["loss_rel"], "param_rel_max": out["param_rel_max"],
        "bound": DIST_MOE_REL}})
    check(out["split_moe_calls"][1] > 0 and out["split_moe_calls"][0]
          == out["split_moe_calls"][1],
          f"{arch}: MoE calls on split experts {out['split_moe_calls']}")
    check(out["loss_rel"] <= DIST_MOE_REL and out["param_rel_max"]
          <= DIST_MOE_REL, f"{arch}: microbatched sharded step off: losses "
          f"{losses} vs {ref_losses}, parameters {out['param_rel_max']}")
    for run in ("sharded", "unsharded"):
        counts = out[run]["launches"]
        check(train_launches_ok(counts, kernel, expected),
              f"{arch} {run}: launches {counts}, expected {kernel} "
              f"{expected}")
    return {"kernel": kernel, "launches": out["sharded"]["launches"][kernel]}


def phase_distributed(torch, kops, smi: str) -> dict:
    """23. The distributed layer on a one-rank NCCL process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                                rank=0, world_size=1,
                                device_id=torch.device("cuda", 0))
        try:
            mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("data", "model"))
            first = None
            for arch, depth in DIST_ARMS:
                arm = dist_arm(torch, kops, mesh, arch, depth)
                launches[arm["kernel"]] = (launches.get(arm["kernel"], 0)
                                           + arm["launches"])
                first = first or arm
            dist_compress(torch, first["api"], first["batch"])
            del first, arm
            gc.collect()
            for arch, depth, b, n in DIST_MIXER_ARMS:
                arm = dist_arm(torch, kops, mesh, arch, depth, b, n)
                launches[arm["kernel"]] = (launches.get(arm["kernel"], 0)
                                           + arm["launches"])
                del arm
                gc.collect()
            dist_collectives(torch)
            for arch, depth in DIST_ARMS:
                arm = dist_resume_arm(torch, kops, mesh, arch, depth)
                launches[arm["kernel"]] += arm["launches"]
            arm = dist_moe_microbatched(torch, kops, mesh)
            launches[arm["kernel"]] += arm["launches"]
        finally:
            dist.destroy_process_group()
    dist_dryrun()
    wall = time.perf_counter() - t0
    emit({"phase": "distributed", "wall_s": wall,
          "predicted_wall_s": DIST_PRED_S, "card": smi})
    return launches


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, default=SRC,
                    help="the directory holding repro_torch (default: the "
                    "checkout's src/), e.g. another commit's, to time its "
                    "kernels with this script's phases")
    ap.add_argument("--only", choices=["parity", "wkv_parity", "lanes",
                                       "serve", "analysis", "resume",
                                       "serve_rwkv", "serve_analysis",
                                       "serve_moe", "serve_hybrid",
                                       "serve_vlm", "encdec",
                                       "train_families", "flash_parity",
                                       "query_split", "distributed"],
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
        elif args.only == "lanes":
            phase_lanes(torch, kops)
        elif args.only == "analysis":
            phase_analysis(torch, kops)
        elif args.only == "resume":
            phase_resume(torch, kops)
        elif args.only == "serve_rwkv":
            phase_serve_rwkv(torch, kops, smi)
        elif args.only == "serve_moe":
            phase_serve_family(torch, kops, smi, MOE)
        elif args.only == "serve_hybrid":
            phase_serve_family(torch, kops, smi, HYBRID)
        elif args.only == "serve_vlm":
            phase_serve_family(torch, kops, smi, VLM)
        elif args.only == "encdec":
            phase_encdec(torch, kops, smi)
        elif args.only == "train_families":
            phase_train_families(torch, kops, smi)
        elif args.only == "flash_parity":
            phase_flash_parity(torch, kops, ptxas)
        elif args.only == "query_split":
            phase_query_split(torch, kops)
        elif args.only == "distributed":
            phase_distributed(torch, kops, smi)
        elif args.only == "serve_analysis":
            outs = [phase_serve(torch, kops, arch)[2]
                    for arch in ("smollm-135m@inhibitor", "smollm-135m")]
            phase_serve_analysis(torch, kops, smi, outs)
        elif args.only == "serve":
            for arch in ("smollm-135m@inhibitor", "smollm-135m"):
                phase_serve(torch, kops, arch)
            if args.src.resolve() == SRC.resolve():
                phase_serve_trace(torch)
        else:
            phase_wkv_parity(torch)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                     "count": torch.cuda.device_count()}})
        return 0
    t_phase = {}
    t0 = time.perf_counter()
    results, timings = phase_parity(torch, kpaged)
    flash_results, flash_timings = phase_flash_parity(torch, kops, ptxas)
    results.update(flash_results)
    timings.update(flash_timings)
    t_phase["parity"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    split_results, split_timings, split_launches = phase_query_split(torch,
                                                                     kops)
    for name, r in split_results.items():
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                           r["max_abs_err"])
    t_phase["query_split"] = time.perf_counter() - t0
    launches = {}
    serve_outs = []
    t0 = time.perf_counter()
    for arch in ("smollm-135m@inhibitor", "smollm-135m"):
        kernel, n, serve_out = phase_serve(torch, kops, arch)
        launches[kernel] = n
        serve_outs.append(serve_out)
    phase_serve_trace(torch)
    phase_decode_paths(torch)
    t_phase["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for arch in ("smollm-135m@inhibitor", "smollm-135m"):
        kernel, n, train_out = phase_train(torch, kops, arch)
        launches[kernel] = n
        if kernel in BACKWARD_KERNEL:
            bwd = BACKWARD_KERNEL[kernel]
            launches[bwd] = train_out["launches"][bwd]
    phase_train_xcheck(torch, kops)
    t_phase["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    results["wkv6"], timings["wkv6"] = phase_wkv_parity(torch)
    t_phase["wkv_parity"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches["wkv6"], _ = phase_rwkv_train(torch, kops)
    phase_rwkv_xcheck(torch, kops)
    forward_launches, _, rwkv_params = phase_rwkv_forward(torch, kops)
    t_phase["rwkv"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rwkv_serve = phase_serve_rwkv(torch, kops, smi, rwkv_params)
    del rwkv_params
    gc.collect()
    torch.cuda.empty_cache()
    t_phase["serve_rwkv"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_lanes(torch, kops)
    t_phase["lanes"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_analysis(torch, kops)
    t_phase["analysis"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    resume_launches = phase_resume(torch, kops)
    t_phase["resume"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_serve_analysis(torch, kops, smi, serve_outs + [rwkv_serve])
    t_phase["serve_analysis"] = time.perf_counter() - t0
    family_launches = {}
    for phase, arch in (("serve_moe", MOE), ("serve_hybrid", HYBRID),
                        ("serve_vlm", VLM)):
        t0 = time.perf_counter()
        family_launches[phase] = phase_serve_family(torch, kops, smi, arch)
        t_phase[phase] = time.perf_counter() - t0
    t0 = time.perf_counter()
    encdec_launches = phase_encdec(torch, kops, smi)
    t_phase["encdec"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_family_launches = phase_train_families(torch, kops, smi)
    t_phase["train_families"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dist_launches = phase_distributed(torch, kops, smi)
    t_phase["distributed"] = time.perf_counter() - t0

    sources = {"paged": "src/repro_torch/csrc/paged_decode.cu",
               "flash": "src/repro_torch/csrc/flash_prefill.cu",
               "flash_inhibitor_bwd":
               "src/repro_torch/csrc/flash_inhibitor_bwd.cu",
               "wkv6": "src/repro_torch/csrc/wkv6.cu"}
    # the WKV kernel last (its entry is amended below)
    replaces = {"paged_inhibitor":
                "src/repro/kernels/paged.py:124 _paged_inhibitor_kernel",
                "paged_attention":
                "src/repro/kernels/paged.py:259 _paged_attention_kernel",
                "flash_inhibitor":
                "src/repro/kernels/inhibitor.py:99 _flash_inhibitor_kernel",
                "flash_attention":
                "src/repro/kernels/flash.py:35 _flash_attention_kernel",
                "flash_inhibitor_bwd": "none: the reference recomputes "
                "through its analytic VJP (src/repro/kernels/ops.py "
                "_fi_bwd)",
                "wkv6": "src/repro/kernels/rwkv6.py:43 _wkv6_kernel"}
    kernels = []
    for name in replaces:
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": sources.get(name, sources[name.split("_")[0]]),
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": results[name]["max_abs_err"],
            "tol": results[name]["tol"], "ms": t["ms"],
            "kernel_ms": t["ms"], "device_us": t.get("device_us"),
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    # the flash kernels' other main path: the resume phase's training
    for k in kernels:
        if k["name"] in resume_launches:
            k["launches_resume"] = resume_launches[k["name"]]
    # the flash kernels' main paths of phases 20-22 (llava's image
    # prefill, seamless's encoder and teacher-forced decoder, the
    # families' training) and their timings at those shapes (phase 6)
    for k in kernels:
        if k["name"] in ("flash_inhibitor", "flash_attention"):
            k["launches_image_prefill"] = family_launches["serve_vlm"][
                "extra"][k["name"]]
            k["launches_encdec"] = encdec_launches[k["name"]]
            k["launches_train_families"] = train_family_launches.get(
                k["name"], 0)
            k["launches_distributed"] = dist_launches.get(k["name"], 0)
            # phase 6a: the training entries on query slices with offsets
            k["launches_query_split"] = split_launches[k["name"]]
            k["query_split"] = {
                label: {key: t[k["name"]][key] for key in
                        ("shape", "ms", "whole_ms", "device_us", "bound_ms",
                         "bound_by", "plain_ms", "library_ms",
                         "bit_equal_whole")}
                for label, t in split_timings.items() if k["name"] in t}
            k["family_shapes"] = {
                label: {key: t[k["name"]][key] for key in
                        ("ms", "device_us", "bound_ms", "bound_by",
                         "plain_ms", "library_ms", "block_q")}
                for label, t in timings["family_shapes"].items()}
    # the paged kernels' other main paths: the MoE, hybrid and vlm
    # families served, and their timings at those families' decode shapes
    for k in kernels:
        if k["name"] in ("paged_inhibitor", "paged_attention"):
            for phase, per_kernel in family_launches.items():
                k[f"launches_{phase}"] = per_kernel[k["name"]]
            k["serve_shapes"] = {
                arch: {key: t[k["name"]][key] for key in
                       ("ms", "device_us", "bound_ms", "bound_by", "grids",
                        "plain_ms", "library_ms")}
                for arch, t in timings["serve_shapes"].items()}
    # the WKV kernel's other main path: the full-depth eval forward
    kernels[-1]["launches_full_depth_forward"] = forward_launches
    # and the sharded train step of phase 23, on the time-mix's heads
    kernels[-1]["launches_distributed"] = dist_launches.get("wkv6", 0)
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
