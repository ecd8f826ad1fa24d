"""Static analysis of the port's serving hot path.

Port of the serve half of :mod:`repro.analysis`:
:mod:`repro_torch.analysis.serve_static` proves the engine's compile set
finite (the retrace budget: one static step, a CUDA graph on the card,
per prefill chunk bucket and per decode table-width bucket) and audits
the tick path's host<->device transfers.
"""

from repro_torch.analysis.serve_static import (  # noqa: F401
    audit_engine_file, audit_sync_sites, audit_telemetry_file,
    retrace_budget, sync_summary)
