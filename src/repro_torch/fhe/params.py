"""TFHE macro-parameter selection from circuit statistics.

The port's own copy of :mod:`repro.fhe.params` (pure python).

Mirrors what the Concrete optimizer (Bergerat et al. 2023) does from the
outside: given the message-space bit-width a circuit's PBS inputs require,
pick (polySize, lweDim, decomposition) meeting the noise/failure budget.
The table below follows the published Concrete parameter curves at
p_fail ≈ 2⁻⁴⁰ and reproduces the paper's Table 2 structure: polySize
doubles when the PBS message width crosses ~6 bits, lweDim creeps with
width, and the dot-product arm lands 1–2 bits (and often one polySize
step) above the inhibitor arm.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TfheParams:
    lwe_dim: int
    poly_size: int
    base_log: int
    level: int
    msg_bits: int        # message space the PBS table must cover


# (max message bits at PBS) -> parameter point (Concrete-style curve)
_PARAM_CURVE = (
    (4, TfheParams(lwe_dim=750, poly_size=1024, base_log=23, level=1, msg_bits=4)),
    (5, TfheParams(lwe_dim=800, poly_size=2048, base_log=23, level=1, msg_bits=5)),
    (6, TfheParams(lwe_dim=840, poly_size=2048, base_log=23, level=1, msg_bits=6)),
    (7, TfheParams(lwe_dim=870, poly_size=4096, base_log=22, level=1, msg_bits=7)),
    (8, TfheParams(lwe_dim=900, poly_size=4096, base_log=22, level=1, msg_bits=8)),
    (9, TfheParams(lwe_dim=930, poly_size=8192, base_log=15, level=2, msg_bits=9)),
    (10, TfheParams(lwe_dim=950, poly_size=8192, base_log=15, level=2, msg_bits=10)),
    (12, TfheParams(lwe_dim=980, poly_size=16384, base_log=15, level=2, msg_bits=12)),
    (16, TfheParams(lwe_dim=1024, poly_size=32768, base_log=9, level=3, msg_bits=16)),
)


def select_params(max_bits_at_pbs: int) -> TfheParams:
    for bits, params in _PARAM_CURVE:
        if max_bits_at_pbs <= bits:
            return params
    raise ValueError(
        f"message width {max_bits_at_pbs} bits exceeds the 16-bit TFHE "
        "table-lookup ceiling (paper §Computational Efficiency)")


def _worst_pbs_scope(report, kind: str):
    """(scope name, width) of the block-level ``max_bits_at_pbs`` high-
    water, refusing a report without any PBS site: selecting the smallest
    parameter point for a circuit whose widths were simply never observed
    would be silent nonsense, not a cheap circuit."""
    if not report:
        raise ValueError(f"empty {kind} cost report: run a lane forward "
                         "before selecting parameters")
    worst_name, worst = max(report.items(),
                            key=lambda kv: kv[1].get("max_bits_at_pbs", 0))
    worst_bits = worst.get("max_bits_at_pbs", 0)
    if worst_bits <= 0:
        raise ValueError(
            f"no scope in the {kind} cost report observed a PBS "
            f"(max_bits_at_pbs is 0/absent everywhere across "
            f"{sorted(report)}); parameters are selected from PBS message "
            "widths, so a PBS-free trace cannot drive selection")
    return worst_name, worst_bits


def select_params_for_report(report, *, static_report=None) -> TfheParams:
    """Parameter selection from a *full-block* per-layer cost report.

    ``report`` maps layer/scope name → cost summary (the
    :meth:`~repro_torch.fhe.tfhe_sim.FheContext.scope_report` of an end-to-end
    lane forward).  One parameter set must serve every PBS in the
    circuit, so selection keys on the block-level ``max_bits_at_pbs``
    high-water — not just the attention op's — and a width beyond the
    supported table fails loudly *naming the offending layer*, which is
    the actionable signal (lower that layer's fixed-point precision or
    add a rescale before its LUT).

    ``static_report``, when given, is the per-scope report of the static
    interval analysis of the same circuit
    (:mod:`repro_torch.analysis`): every measured width is
    cross-checked against the proven bound, and a measured width *exceeding* the static bound fails loudly — observing
    what the analysis proved impossible means the analysis is unsound
    (or the two traces ran different circuits), and parameters derived
    from either are untrustworthy.
    """
    worst_name, worst_bits = _worst_pbs_scope(report, "measured")
    if static_report is not None:
        for name, s in report.items():
            measured = s.get("max_bits_at_pbs", 0)
            bound = static_report.get(name, {}).get("max_bits_at_pbs")
            if bound is None:
                raise ValueError(
                    f"scope {name!r} is missing from the static report "
                    f"(static scopes: {sorted(static_report)}); the "
                    "measured and static traces ran different circuits")
            if measured > bound:
                raise ValueError(
                    f"SOUNDNESS BUG: scope {name!r} measured "
                    f"{measured}-bit PBS messages but the static analysis "
                    f"proved a {bound}-bit worst case; the interval "
                    "analysis (or the circuit pairing) is wrong — do not "
                    "trust either parameter selection")
    try:
        return select_params(worst_bits)
    except ValueError as e:
        raise ValueError(
            f"layer {worst_name!r} needs {worst_bits}-bit PBS messages: "
            f"{e}") from None


def select_params_static(static_report) -> TfheParams:
    """Parameter selection from the *proven* block-level width.

    ``static_report`` is the per-scope report of an interval-lane forward
    (the reference's ``repro.analysis.interval_lane``) — the same schema
    as the measured report, but every ``max_bits_at_pbs`` is
    a worst case over all inputs in the declared quantized ranges rather
    than one sample's high-water.  Parameters chosen here are therefore
    sound for *any* input: this is the selection deployments should use
    (the measured selection can under-provision on an unlucky input and
    decrypt to garbage with no error).
    """
    worst_name, worst_bits = _worst_pbs_scope(static_report, "static")
    try:
        return select_params(worst_bits)
    except ValueError as e:
        raise ValueError(
            f"layer {worst_name!r} is statically proven to need "
            f"{worst_bits}-bit PBS messages: {e}") from None
