"""Static analysis of the port: the FHE circuit and the serving hot path.

Port of :mod:`repro.analysis`.  The measured story (``fhe_sim``) observes one
sample forward; the interval analysis *proves* the same quantities for
every input in the declared quantized ranges: per-scope op counts
(exactly equal to measured — the circuit's control flow is
input-independent), worst-case PBS message widths (dominating any
measured high-water), zero cipher×cipher products on the inhibitor arm,
and LUT-domain/table-width verification.  It is exact int64 arithmetic
on the host and launches nothing on the card.

    python -m repro_torch.analysis --config paper-tiny   # ANALYSIS_fhe.json
    python -m repro_torch.analysis.lint                  # lane discipline

:mod:`repro_torch.analysis.serve_static` proves the engine's compile set
finite (the retrace budget: one static step, a CUDA graph on the card,
per prefill chunk bucket and per decode table-width bucket), audits the
tick path's host<->device transfers, checks every enumerated step's
signature and prices it with the static roofline of
:mod:`repro_torch.analysis.costmodel` (aten operations walked on
``meta`` tensors), which also ranks the kernel autotune's candidates.

    python -m repro_torch.analysis.serve --config paper-tiny  # ANALYSIS_serve.json
"""

from repro_torch.analysis.analyzer import (  # noqa: F401
    DEFAULT_MECHANISMS, LUT_BITS_CEILING, SCHEMA_VERSION, analyze_config,
    analyze_qlm, format_report)
from repro_torch.analysis.interval import (  # noqa: F401
    GUARD, IntervalOverflow, IntervalTensor, as_interval, matmul_plain_bounds,
    mul_bounds, table_range_minmax)
from repro_torch.analysis.interval_lane import IntervalLane  # noqa: F401
from repro_torch.analysis.costmodel import (  # noqa: F401
    DEFAULT_PLATFORM, H100_SXM, Costs, Platform, kernel_prior,
    rank_kernel_candidates, roofline, torch_costs)
from repro_torch.analysis.serve_static import (  # noqa: F401
    analyze_serve, audit_engine_file, audit_sync_sites, audit_telemetry_file,
    cross_check_bench, retrace_budget, sync_summary)
