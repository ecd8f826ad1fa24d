"""Whole-model static FHE circuit analysis (abstract interpretation).

Port of :mod:`repro.analysis.analyzer`.  :func:`analyze_qlm` runs the
ordinary lane-parameterized forward
(:func:`repro_torch.models.transformer.lm_forward_lane`) on the
:class:`~repro_torch.analysis.interval_lane.IntervalLane` — no concrete token
values, no activations — and packages the resulting static trace into a
report with the same per-scope schema the ``fhe_sim`` measured report
uses, plus what only a static analysis can assert:

  * ``cmul_sites``      — every cipher×cipher multiply, attributed to its
                          scope and contraction (``dot_scores`` /
                          ``mix_values`` / the softmax renorm ``mul``);
                          an empty list is a *proof* that the circuit
                          performs zero ciphertext multiplications for
                          any input in the quantized range;
  * ``lut_sites``       — every PBS table: declared domain, worst-case
                          raw input interval, saturation margins, and the
                          table width the PBS must cover;
  * ``lut_verification``— the hard gate: every LUT's (packed) table width
                          must sit within the 16-bit TFHE LUT ceiling;
  * ``value_ranges``    — proven per-scope value intervals;
  * ``params``          — TFHE macro-parameters selected from the proven
                          block-level width
                          (:func:`repro_torch.fhe.params.select_params_static`).

:func:`analyze_config` wraps it for a named architecture (PTQ'ing a
freshly initialized model, drawn on the host with the port's own
initialiser) across both attention mechanisms and returns the
``ANALYSIS_fhe.json`` document the CLI writes and CI gates on.  The whole
analysis is exact integer arithmetic on the host and launches nothing on
the card.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

#: widest table a single PBS can evaluate (paper §Computational
#: Efficiency; mirrors the fhe.params 16-bit curve ceiling)
LUT_BITS_CEILING = 16

SCHEMA_VERSION = 1

DEFAULT_MECHANISMS = ("inhibitor", "dotprod")


def analyze_qlm(qlm, *, seq_len: int, batch: int = 1) -> dict:
    """Statically analyze one PTQ'd LM end to end; returns the report."""
    from repro_torch.analysis.interval_lane import IntervalLane
    from repro_torch.fhe.params import select_params_static
    from repro_torch.models.transformer import lm_forward_lane

    lane = IntervalLane()
    # token *values* are never read by the interval lane (embed uses
    # per-channel vocabulary bounds); the array only supplies (b, s)
    tokens = np.zeros((batch, seq_len), np.int64)
    logits = lm_forward_lane(qlm, lane, tokens)

    per_scope = lane.ctx.scope_report()
    lut_violations = [s for s in lane.lut_sites
                      if s["table_bits"] > LUT_BITS_CEILING]
    report = {
        "mechanism": qlm.cfg.attention.mechanism,
        "seq_len": int(seq_len),
        "batch": int(batch),
        "totals": lane.ctx.summary(),
        "per_scope": per_scope,
        "value_ranges": {k: list(v) for k, v in lane.value_ranges.items()},
        "logits_range": list(logits.extremes()),
        "cmul_sites": list(lane.cmul_sites),
        "zero_cmul_proven": not lane.cmul_sites,
        "lut_sites": list(lane.lut_sites),
        "lut_verification": {
            "n_sites": len(lane.lut_sites),
            "n_saturating": sum(not s["fits_domain"]
                                for s in lane.lut_sites),
            "bits_ceiling": LUT_BITS_CEILING,
            "verified": not lut_violations,
            "violations": lut_violations,
        },
    }
    try:
        p = select_params_static(per_scope)
        report["params"] = {
            "lwe_dim": p.lwe_dim, "poly_size": p.poly_size,
            "base_log": p.base_log, "level": p.level,
            "msg_bits": p.msg_bits,
        }
    except ValueError as e:
        report["params"] = None
        report["params_error"] = str(e)
    return report


def analyze_config(name: str, *, seq_len: int = 8, batch: int = 1,
                   mechanisms: Sequence[str] = DEFAULT_MECHANISMS,
                   seed: int = 0, reduced: Optional[dict] = None) -> dict:
    """Analyze a named architecture for each mechanism.

    Initializes the model on the host from ``seed`` (a CPU
    ``torch.Generator``; the port's draws, not the reference's), PTQ's
    it once per mechanism (the weights are mechanism-independent; only
    the attention hyper-parameter mapping changes), and assembles the
    ``ANALYSIS_fhe.json`` document.  ``reduced`` forwards size overrides
    to ``cfg.reduced(...)``.
    """
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.quant.ptq import ptq_lm

    cfg = get_config(name.replace("_", "-"))
    if reduced:
        cfg = cfg.reduced(**reduced)
    params = get_model(cfg).init(torch.Generator().manual_seed(seed),
                                 device="cpu")

    doc = {
        "schema": SCHEMA_VERSION,
        "config": cfg.name,
        "seq_len": int(seq_len),
        "batch": int(batch),
        "seed": int(seed),
        "mechanisms": {},
    }
    for mech in mechanisms:
        qlm = ptq_lm(params, cfg.with_attention_kind(mech))
        doc["mechanisms"][mech] = analyze_qlm(qlm, seq_len=seq_len,
                                              batch=batch)
    return doc


def format_report(report: dict) -> str:
    """Human-readable per-scope table for one mechanism's report."""
    lines = [f"== {report['mechanism']} — static worst case over the "
             f"quantized input range (T={report['seq_len']}) ==",
             f"{'scope':14s} {'pbs':>8} {'cmuls':>7} {'adds':>9} "
             f"{'bits@pbs':>8}  {'value range':>24}"]
    for name, s in report["per_scope"].items():
        lo, hi = report["value_ranges"].get(name, (0, 0))
        lines.append(
            f"{name:14s} {s['pbs']:>8} {s['cmuls']:>7} {s['adds']:>9} "
            f"{s['max_bits_at_pbs']:>8}  [{lo}, {hi}]")
    tot = report["totals"]
    lines.append(f"{'total':14s} {tot['pbs']:>8} {tot['cmuls']:>7} "
                 f"{tot['adds']:>9} {tot['max_bits_at_pbs']:>8}")
    if report["zero_cmul_proven"]:
        lines.append("cmuls: ZERO, proven for every input in the "
                     "quantized range")
    else:
        for site in report["cmul_sites"]:
            lines.append(f"cmul site: {site['scope']} [{site['op']}] × "
                         f"{site['count']} ({site['pbs_bits']}-bit PBS)")
    lv = report["lut_verification"]
    lines.append(f"LUT domains: {lv['n_sites']} sites, "
                 f"{lv['n_saturating']} saturating, verified="
                 f"{lv['verified']} (ceiling {lv['bits_ceiling']} bits)")
    if report.get("params"):
        p = report["params"]
        lines.append(f"static params: poly={p['poly_size']} "
                     f"lwe={p['lwe_dim']} level={p['level']} "
                     f"(proven {tot['max_bits_at_pbs']}-bit messages)")
    else:
        lines.append(f"static params: UNSELECTABLE — "
                     f"{report.get('params_error')}")
    return "\n".join(lines)
