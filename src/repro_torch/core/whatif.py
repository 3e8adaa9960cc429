"""What-if analysis (paper Section V-B, Table VI) over overlay scenarios
(twin of ``repro.core.whatif``).

Scaling the MFMA cycle table lets users explore faster/slower future MCE
designs.  As the paper notes (Section VI), on real code the speedup is NOT
linear because the compiler fixed the amount of independent work between
MFMAs at compile time; the microbenchmark path below shows the linear
(instruction-isolated) effect.

The single ``mfma_scale`` float generalises to composable
:class:`repro_torch.arch.Overlay` scenarios (clock/memory-latency/bandwidth
scaling, per-instruction table patches); sweeps are overlay *grids* —
see :func:`overlay_table` and :func:`grid_sweep` for the
instruction-isolated (microbenchmark) view, and :func:`workload_grid`
for the whole-workload view through the perf pipeline
(:mod:`repro_torch.perf.pipeline`), over HLO text or a graph the port's
models give (:func:`repro_torch.perf.torch_graph.capture`).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

from repro_torch.arch.overlay import Overlay, overlay_grid
from repro_torch.core import isa
from repro_torch.core.machine import MachineModel
from repro_torch.core.microbench import measure_latency

__all__ = ["scale_table", "scale_sweep", "overlay_table", "grid_sweep",
           "workload_grid"]


def _validated_instrs(machine: MachineModel) -> Sequence[str]:
    if not machine.has_mfma_table:
        raise isa.UnsupportedInstructionError(
            f"{machine.name} has no MFMA cycle table to sweep; pass "
            "instr_names explicitly or use a table-bearing device")
    return machine.supported_instructions(validated_only=True)


def scale_table(machine: MachineModel, scales: Sequence[float] = (1.0, 2.0),
                instr_names: Optional[Sequence[str]] = None,
                n_mfma: int = 2) -> Dict[str, Dict[float, float]]:
    """Reproduces paper Table VI: measured latency per instruction x scale.

    ``with_scale`` semantics: each scale *replaces* the machine's
    ``mfma_scale`` (the paper's CLI knob).  For composable scenarios use
    :func:`overlay_table`.
    """
    if instr_names is None:
        instr_names = _validated_instrs(machine)
    out: Dict[str, Dict[float, float]] = {}
    for name in instr_names:
        out[name] = {}
        for s in scales:
            out[name][s] = measure_latency(machine.with_scale(s), name,
                                           n_mfma)
    return out


def overlay_table(machine: MachineModel, overlays: Sequence[Overlay],
                  instr_names: Optional[Sequence[str]] = None,
                  n_mfma: int = 2) -> Dict[str, Dict[str, float]]:
    """Measured Listing-1 latency per instruction x overlay scenario.

    Returns ``{instr: {overlay_label: cycles}}``; the general form of the
    paper's Table VI where a scenario may also turn clocks, memory
    latencies or individual table entries.
    """
    if instr_names is None:
        instr_names = _validated_instrs(machine)
    out: Dict[str, Dict[str, float]] = {}
    for name in instr_names:
        out[name] = {}
        for ov in overlays:
            m = machine.with_overlay(ov)
            out[name][ov.describe()] = measure_latency(m, name, n_mfma)
    return out


def scale_sweep(machine: MachineModel, instr_name: str,
                scales: Iterable[float]) -> Dict[float, float]:
    return {s: measure_latency(machine.with_scale(s), instr_name, 4)
            for s in scales}


def grid_sweep(machine: MachineModel, instr_name: str, *, n_mfma: int = 4,
               **axes: Iterable[float]) -> Dict[str, float]:
    """Full-grid microbenchmark sweep over overlay knobs.

    >>> grid_sweep(m, "fp32_16x16x16fp16",
    ...            mfma_scale=(0.5, 1, 2), mem_latency_scale=(1, 2))
    {'mfma x0.5': ..., 'mfma x0.5, memlat x2': ..., ...}
    """
    out: Dict[str, float] = {}
    for ov in overlay_grid(**axes):
        out[ov.describe()] = measure_latency(machine.with_overlay(ov),
                                             instr_name, n_mfma)
    return out



def workload_grid(workload, machine, *, engine="mfma", **axes):
    """Whole-workload scenario grid through the unified pipeline.

    The workload-level counterpart of :func:`grid_sweep`: ``workload`` is
    HLO text / a ``KernelGraph`` (a captured one too) / a dry-run
    artifact path, ``engine`` any registered cost engine, and the result
    maps each overlay scenario to its shared-schema
    :class:`repro_torch.perf.Report` (parsed exactly once across the
    whole grid).

    >>> workload_grid(graph, "mi300x",
    ...               mfma_scale=(0.5, 1, 2), clock_scale=(1, 1.2))
    {'mfma x0.5': Report(...), ...}
    """
    from repro_torch.perf.pipeline import predict  # local: keep core light
    overlays = overlay_grid(**axes)
    reports = predict(workload, device=machine, engine=engine,
                      overlays=overlays)
    return {ov.describe(): rep for ov, rep in zip(overlays, reports)}
