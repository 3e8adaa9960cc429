"""Compiled-HLO -> MFMA accounting — compatibility shim over
``repro_torch.perf`` (twin of ``repro.core.hlo_bridge``).

The HLO text parsing and the closed-form MCE throughput model live in
the performance pipeline (:mod:`repro_torch.perf.hlo_ir` for parsing,
:mod:`repro_torch.perf.engines` for costing), where the roofline,
scoreboard and what-if sweeps share them.  The legacy API is kept as
the reference keeps it — same functions, same result shapes, same
numbers (``tests/test_torch_hlo_bridge.py`` holds it to the reference's)
— and warns once that it is deprecated.  New code should call
``repro_torch.perf.predict`` instead.  Like the engines, the analytic
model here raises ``ValueError`` on the H100, which has neither an MFMA
cycle table nor MXUs.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.machine import MachineModel, as_machine
from repro_torch.perf import hlo_ir
from repro_torch.perf.engines import (  # noqa: F401
    best_instr, cost_dot_pairs, gemm_stream, mfma_count, simulate_gemm_cu)
from repro_torch.perf.hlo_ir import DotOp  # noqa: F401  (legacy re-export)

__all__ = ["DotOp", "parse_dots", "parse_collectives", "best_instr",
           "mfma_count", "predict", "predict_dots", "Prediction",
           "gemm_stream", "simulate_gemm_cu", "collective_bytes_total"]

# Legacy aliases (hlo_analysis and external notebooks imported these):
_BYTES = hlo_ir.BYTES_PER_ELEM
_mnk = hlo_ir._mnk
_parse_int_list = hlo_ir._parse_int_list
_DIMS_RE = hlo_ir.DIMS_RE
_GROUPS_RE = hlo_ir.GROUPS_RE
_GROUPS_LIST_RE = hlo_ir.GROUPS_LIST_RE
_SHAPE_RE = hlo_ir.SHAPE_RE

_WARNED = False


def _warn_deprecated() -> None:
    """One-shot: this surface is kept for parity tests and old notebooks
    only, and goes away once the fleet layer's consumers are migrated."""
    global _WARNED
    if not _WARNED:
        _WARNED = True
        warnings.warn(
            "repro_torch.core.hlo_bridge.predict is deprecated; call "
            "repro_torch.perf.predict(workload, device=..., engine='mfma') "
            "— same numbers, one model home", DeprecationWarning,
            stacklevel=3)


def parse_dots(text: str) -> List[DotOp]:
    """Extract every dot op (each counted once, even inside while bodies).

    Accepts StableHLO (``lowered.as_text()``) or post-SPMD HLO
    (``compiled.as_text()``).  Thin wrapper over
    :func:`repro_torch.perf.hlo_ir.parse_static_dots`.
    """
    return [op.as_dot() for op in hlo_ir.parse_static_dots(text)]


def parse_collectives(hlo_text: str) -> Dict[str, Dict[str, float]]:
    """Per-collective-kind stats from post-SPMD HLO text (each op counted
    once).  Returns {kind: {count, result_bytes, wire_bytes}} — see
    :func:`repro_torch.perf.hlo_ir.parse_collectives_static` for the ring-model
    wire-byte accounting."""
    return hlo_ir.parse_collectives_static(hlo_text)


def collective_bytes_total(hlo_text: str) -> float:
    """Total per-device wire bytes across all collectives."""
    return hlo_ir.collective_wire_bytes(hlo_text)


@dataclasses.dataclass
class Prediction:
    machine: str
    mfma_scale: float
    total_mfma: int
    mce_cycles: float          # throughput-bound cycles on the whole chip
    mce_time_s: float
    matrix_flops: float        # flops executed by matrix units
    instr_mix: Dict[str, int]
    repetition_factor: float   # cost_analysis flops / parsed-once flops


def predict_dots(machine: MachineModel,
                 dots_with_counts: Sequence[Tuple[DotOp, float]],
                 fallback_dtype: str = "bf16",
                 repetition_factor: float = 1.0) -> Prediction:
    """Matrix-unit-bound time for an explicit (dot, executed-count) list.

    ``machine`` may be a MachineModel, a ``repro_torch.arch.DeviceSpec``, or a
    registered device name.  Delegates to the ONE model home,
    :func:`repro_torch.perf.engines.cost_dot_pairs` (also behind
    ``MfmaAnalyticEngine``), so legacy and pipeline results agree exactly.
    """
    machine = as_machine(machine)
    costs = cost_dot_pairs(machine, dots_with_counts,
                           fallback_dtype=fallback_dtype)
    return Prediction(machine=machine.name, mfma_scale=machine.mfma_scale,
                      total_mfma=int(costs.total_mfma),
                      mce_cycles=costs.total_cycles,
                      mce_time_s=costs.time_s,
                      matrix_flops=costs.matrix_flops,
                      instr_mix=dict(costs.instr_mix),
                      repetition_factor=repetition_factor)


def predict(machine: MachineModel, hlo_text: str,
            cost_flops: Optional[float] = None,
            fallback_dtype: str = "bf16") -> Prediction:
    """Matrix-unit-bound time prediction for a compiled module.

    ``cost_flops``: when given, the parsed (static) dot mix is renormalised
    so total matrix FLOPs match the caller's dynamic count (use
    :func:`repro_torch.core.hlo_analysis.analyze` for loop-aware counts —
    XLA:CPU's own ``cost_analysis()`` counts while bodies once).

    .. deprecated:: use :func:`repro_torch.perf.predict` instead.
    """
    _warn_deprecated()
    machine = as_machine(machine)
    dots = parse_dots(hlo_text)
    parsed_flops = float(sum(d.flops for d in dots))
    rep = 1.0
    if cost_flops and parsed_flops > 0:
        rep = max(1.0, cost_flops / parsed_flops)
    return predict_dots(machine, [(d, rep) for d in dots],
                        fallback_dtype=fallback_dtype, repetition_factor=rep)
