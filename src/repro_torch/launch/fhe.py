"""Privacy-preserving inference: a whole transformer under TFHE.

Port of ``examples/fhe_inference.py``.  The ``paper-tiny`` Inhibitor
Transformer (seeded random init) is post-training-quantized onto the
integer lanes and evaluated — every layer: LayerNorm surrogate, QKV/out
projections, attention, ReLU MLP, residuals, logits — on the ``int`` lane
and under the TFHE circuit simulator (``fhe_sim``), which must agree bit
for bit, next to the dot-product baseline arm.  The per-layer cost report
shows the paper's structural claim at block scale: the inhibitor arm
performs zero ciphertext×ciphertext multiplications.

    python -m repro_torch.launch.fhe [--seq 8] [--device cpu]

Both lanes run on ``--device`` (default: the card).  ``wq`` and ``wk``
are scaled by 1/√head_dim after the init, as the port's parity tests do:
at the plain init every inhibition term of ``paper-tiny`` is zero and the
inhibitor arm's attention would drop out of the logits.  The estimated
encrypted seconds come from the cost model of ``repro_torch.fhe.cost`` —
single-threaded TFHE on a CPU, fitted to published Concrete timings — and
are not a measurement.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.lanes import get_lane
from repro_torch.device import resolve_device
from repro_torch.fhe import pbs_seconds, select_params_for_report
from repro_torch.models import transformer as tfm
from repro_torch.quant.ptq import ptq_lm


def init_params(cfg, seed: int = 0) -> dict:
    """Seeded float parameters (on the host: PTQ reads them there), with
    every layer's wq and wk scaled by 1/√head_dim."""
    params = tfm.init_lm(torch.Generator().manual_seed(seed), cfg,
                         device="cpu")
    for blk in params["blocks"]:
        for w in ("wq", "wk"):
            blk["attn"][w]["kernel"].mul_(cfg.attention.head_dim ** -0.5)
    return params


def run_arm(qlm, tokens, device) -> dict:
    """``qlm``'s forward on the int lane and the fhe_sim lane (both on
    ``device``); raises unless they agree bit for bit."""
    out = {}
    for name in ("int", "fhe_sim"):
        lane = get_lane(name, device=device)
        t0 = time.perf_counter()
        logits = lane.to_numpy(tfm.lm_forward_lane(qlm, lane, tokens))
        out[name] = {"logits": logits, "wall_s": time.perf_counter() - t0,
                     "lane": lane}
    if not np.array_equal(out["int"]["logits"],
                          out["fhe_sim"]["logits"].astype(np.int32)):
        raise AssertionError("the fhe_sim forward is not bit-exact with the "
                             "int lane")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seq", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config("paper-tiny")
    params = init_params(cfg)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                               (1, args.seq))
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"paper-tiny: {cfg.num_layers} layer(s), d_model={cfg.d_model}, "
          f"T={args.seq}, lanes on {where} — client embeds+encrypts "
          "tokens, server computes on ciphertexts\n")

    for mech in ("inhibitor", "dotprod"):
        qlm = ptq_lm(params, cfg.with_attention_kind(mech))
        res = run_arm(qlm, tokens, dev)
        ctx = res["fhe_sim"]["lane"].ctx
        report = ctx.scope_report()
        sel = select_params_for_report(report)
        print(f"== {mech} block — encrypted forward bit-exact with int lane "
              f"(walls on {where}: int {res['int']['wall_s']:.3f} s, "
              f"fhe_sim {res['fhe_sim']['wall_s']:.3f} s) ==")
        print(f"{'layer':14s} {'pbs':>8} {'cmuls':>7} {'adds':>9} "
              f"{'bits@pbs':>8}")
        for name, s in report.items():
            print(f"{name:14s} {s['pbs']:>8} {s['cmuls']:>7} {s['adds']:>9} "
                  f"{s['max_bits_at_pbs']:>8}")
        tot = ctx.summary()
        print(f"{'total':14s} {tot['pbs']:>8} {tot['cmuls']:>7} "
              f"{tot['adds']:>9} {tot['max_bits_at_pbs']:>8}")
        print(f"selected TFHE params: poly={sel.poly_size} lwe={sel.lwe_dim} "
              f"level={sel.level} base_log={sel.base_log} (block high-water "
              f"{tot['max_bits_at_pbs']} bits)")
        print(f"estimated encrypted block time (cost model of "
              f"single-threaded TFHE on a CPU, not a measurement): "
              f"{tot['pbs'] * pbs_seconds(sel):,.0f} s\n")

    print("the inhibitor arm runs the whole block without a single "
          "ciphertext multiplication;\nthe dot-product arm pays 2 PBS per "
          "product in QKᵀ, softmax renorm, and S·V.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
