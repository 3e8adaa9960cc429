"""repro_torch.perf — the unified performance-model pipeline (twin of
``repro.perf``).

One :class:`KernelGraph` IR behind pluggable cost engines, cached
artifacts, and fleet-wide scenario sweeps:

  hlo_ir      — the IR and the HLO text parser (dots, collectives, memory
                ops, while trip counts, CPU-upcast accounting)
  torch_graph — the port's own graph source: ``capture(fn, *args)``
                records a PyTorch function's aten ops on the meta device
  engines     — CostEngine protocol: RooflineEngine / MfmaAnalyticEngine /
                ScoreboardEngine, one shared Report schema (only the
                roofline prices the H100)
  report      — Report/OpCost result types + sweep tables
  cache       — content-hashed memoization of parsed graphs + artifacts
  pipeline    — predict(workload, device=, engine=, overlays=) and the
                cartesian sweep() that parses each module exactly once

``repro_torch.core.hlo_bridge`` and ``repro_torch.core.hlo_analysis``
remain as thin compatibility shims; new code should target this package.
"""

from repro_torch.perf.hlo_ir import (  # noqa: F401
    BYTES_PER_ELEM, DotOp, KernelGraph, KernelOp, parse_module,
    parse_static_dots)
from repro_torch.perf.report import (  # noqa: F401
    OpCost, Report, format_reports)
from repro_torch.perf.engines import (  # noqa: F401
    CostEngine, MfmaAnalyticEngine, RooflineEngine, ScoreboardEngine)
from repro_torch.perf.cache import (  # noqa: F401
    cache_stats, clear_cache, parse_cached)
from repro_torch.perf.pipeline import (  # noqa: F401
    as_graph, get_engine, list_engines, predict, register_engine, sweep)

__all__ = [
    "BYTES_PER_ELEM", "DotOp", "KernelOp", "KernelGraph",
    "parse_module", "parse_static_dots",
    "OpCost", "Report", "format_reports",
    "CostEngine", "RooflineEngine", "MfmaAnalyticEngine", "ScoreboardEngine",
    "parse_cached", "cache_stats", "clear_cache",
    "predict", "sweep", "as_graph",
    "register_engine", "get_engine", "list_engines",
]
