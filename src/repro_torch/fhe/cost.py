"""TFHE execution-time cost model, calibrated against the paper's Table 4.

The port's own copy of :mod:`repro.fhe.cost` (pure python).  Its seconds
are a *model* of single-threaded TFHE on a CPU (published Concrete
parameter curves), never a measurement on any device.

PBS dominates TFHE runtime; its cost grows ~linearly in polySize·level and
~linearly in lweDim (blind-rotation external products).  We model

    t_pbs(params) = C · (poly_size / 2048) · level · (lwe_dim / 800)
    t_circuit     = pbs_count · t_pbs + adds · t_add + lit_muls · t_lit

and calibrate C (seconds per reference PBS) against the paper's published
single-thread timings.  With the PBS inventories of
:mod:`repro_torch.fhe.circuits`, C ≈ 25 ms reproduces Table 4 within ~2×
across both arms and all four sequence lengths, preserving the headline 3–6×
inhibitor speedup — the quantity this model exists to verify.
"""

from __future__ import annotations

from repro_torch.fhe.params import TfheParams, select_params

# calibrated constants (single CPU thread, Concrete v1-era)
PBS_REF_SECONDS = 0.025     # one PBS at poly 2048 / level 1 / lwe 800
ADD_SECONDS = 4e-7          # levelled ciphertext add
LIT_MUL_SECONDS = 6e-7      # cleartext-constant multiply


def pbs_seconds(params: TfheParams) -> float:
    return (PBS_REF_SECONDS * (params.poly_size / 2048.0) * params.level
            * (params.lwe_dim / 800.0))


def circuit_seconds(summary: dict, params: TfheParams | None = None) -> float:
    """Estimated wall time for a circuit's cost summary."""
    p = params or select_params(summary["max_bits_at_pbs"])
    return (summary["pbs"] * pbs_seconds(p)
            + summary["adds"] * ADD_SECONDS
            + summary["lit_muls"] * LIT_MUL_SECONDS)


def describe(summary: dict) -> dict:
    p = select_params(summary["max_bits_at_pbs"])
    return {
        **summary,
        "lwe_dim": p.lwe_dim,
        "poly_size": p.poly_size,
        "base_log": p.base_log,
        "level": p.level,
        "est_seconds": round(circuit_seconds(summary, p), 3),
    }
