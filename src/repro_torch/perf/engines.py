"""Pluggable cost engines over one
:class:`~repro_torch.perf.hlo_ir.KernelGraph` (twin of
``repro.perf.engines``).

Three built-in implementations of the :class:`CostEngine` protocol, all
emitting the shared :class:`~repro_torch.perf.report.Report` schema:

* :class:`RooflineEngine` — peaks/bandwidths from the device spec
  (compute vs HBM vs interconnect bound, the launch-time roofline);
* :class:`MfmaAnalyticEngine` — the paper's closed-form MCE throughput
  model (each MCE retires one MFMA per ``mfma_cycles``; MXU systolic
  passes on TPUs), previously ``hlo_bridge.predict_dots``;
* :class:`ScoreboardEngine` — lowers representative GEMM tile loops to
  ``repro_torch.core.program`` IR, runs the event-driven NRDY_MATRIX_CORE
  simulator, and extrapolates measured per-MFMA throughput to the module
  (validates the analytic issue-semantics assumption, including issue
  overhead the closed form ignores).

All engines compose with ``repro_torch.arch`` overlay scenarios: pass a
machine built via ``get_machine(name, overlay=...)`` (or let
:func:`repro_torch.perf.pipeline.predict` do it).  Adding an engine is
implementing ``name`` + ``estimate(graph, machine)`` and registering it
(:func:`repro_torch.perf.pipeline.register_engine`).

**The H100.**  The reference has no device with neither an MFMA cycle
table nor MXUs; on one its analytic model skips every dot and reports 0 s
at 0% utilisation.  The H100's table stays empty (its tensor cores run no
AMD instruction), so here the MFMA and scoreboard engines, and the
analytic model under them (:func:`cost_dot_pairs`), raise a descriptive
``ValueError`` on such a device instead.  Only :class:`RooflineEngine`
prices the H100.  The reference's five devices behave exactly as in the
reference.
"""

from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Dict, List, Optional, Protocol, Sequence, Tuple

from repro_torch.arch import select as arch_select
from repro_torch.core import isa
from repro_torch.core.machine import MachineModel, as_machine
# the representative-tile measurement path lives with the other
# microbenchmarks; re-exported here for legacy call sites
from repro_torch.core.microbench import (gemm_stream, measure_plan_throughput,
                                   simulate_gemm_cu)
from repro_torch.perf.hlo_ir import KernelGraph
from repro_torch.perf.report import OpCost, Report

__all__ = [
    "CostEngine", "RooflineEngine", "MfmaAnalyticEngine", "ScoreboardEngine",
    "best_instr", "mfma_count", "cost_dot_pairs", "DotCosts",
    "bound_time", "roofline_times", "gemm_stream", "simulate_gemm_cu",
    "plan_for_dot", "plan_for_graph",
]


# ---------------------------------------------------------------------------
# Instruction selection + counting
# ---------------------------------------------------------------------------

def _require_matrix_model(machine: MachineModel, engine: str) -> None:
    """Raise ``ValueError`` when ``machine`` has neither an MFMA cycle
    table nor MXUs (the H100): the analytic and scoreboard models have
    no matrix unit to price it with."""
    if not machine.mxu_count and not machine.has_mfma_table:
        raise ValueError(
            f"{engine}: {machine.name} has neither an MFMA cycle table nor "
            "MXUs, so this engine cannot price its matrix work; price it "
            "with the roofline engine (engine='roofline', RooflineEngine)")


def best_instr(machine: MachineModel, hlo_dtype: str) -> Optional[str]:
    """Highest-throughput supported MFMA instruction for an operand dtype.

    Thin wrapper: instruction selection is a device property owned by
    :mod:`repro_torch.arch.select`; the machine contributes its backing
    spec and the active ``mfma_scale``.
    """
    machine = as_machine(machine)
    spec = machine.spec
    if spec is None and machine.gpu_table is not None:
        from repro_torch.arch.registry import get_device
        spec = get_device(machine.gpu_table)   # hand-built legacy model
    if spec is None or not spec.has_cycle_table:
        return None
    return arch_select.best_mfma_for_hlo(spec, hlo_dtype,
                                         mfma_scale=machine.mfma_scale)


def mfma_count(dot, instr_name: str) -> int:
    """MFMA instructions to cover a dot with ``instr_name`` tiles."""
    i = isa.lookup(instr_name)
    tiles = (dot.batch * math.ceil(dot.m / i.m) * math.ceil(dot.n / i.n)
             * math.ceil(dot.k / i.k))
    return math.ceil(tiles / i.blocks)


@dataclasses.dataclass
class DotCosts:
    """Aggregate of the analytic matrix-unit model over a dot list."""

    total_cycles: float = 0.0
    time_s: float = 0.0
    total_mfma: float = 0.0
    matrix_flops: float = 0.0
    instr_mix: Dict[str, int] = dataclasses.field(default_factory=dict)
    per_op: List[OpCost] = dataclasses.field(default_factory=list)


def cost_dot_pairs(machine: MachineModel, pairs: Sequence[Tuple],
                   fallback_dtype: str = "bf16") -> DotCosts:
    """The closed-form MCE/MXU throughput model over (dot, count) pairs.

    This is the ONE home of the paper's analytic issue semantics (each MCE
    retires one MFMA per ``mfma_cycles``, no intra-WF pipelining, full
    cross-WF/SIMD parallelism; 128x128 systolic passes on MXUs) —
    ``hlo_bridge.predict_dots`` and :class:`MfmaAnalyticEngine` both call
    in, so they agree exactly by construction.
    """
    machine = as_machine(machine)
    _require_matrix_model(machine, "the analytic MFMA model")
    instr_mix: Dict[str, int] = defaultdict(int)
    out = DotCosts()
    clock_hz = machine.clock_mhz * 1e6

    for d, cnt in pairs:
        if machine.mxu_count:  # TPU analytic path: 128x128 systolic passes
            passes = (d.batch * math.ceil(d.m / machine.mxu_dim)
                      * math.ceil(d.n / machine.mxu_dim)
                      * math.ceil(d.k / machine.mxu_dim))
            # one pass streams mxu_dim rows through the array
            cycles = passes * machine.mxu_dim / machine.mxu_count
            cycles *= machine.mfma_scale  # what-if applies to MXU too
            op_cycles = cnt * cycles
            instr = f"mxu_{machine.mxu_dim}x{machine.mxu_dim}"
            instr_mix[instr] += int(cnt * passes)
            out.total_mfma += cnt * passes
            n_units = int(cnt * passes)
        else:
            instr = best_instr(machine, d.in_dtype) or best_instr(machine, {
                "bf16": "bf16", "f16": "f16"}.get(fallback_dtype, "f32"))
            if instr is None:
                continue
            n = mfma_count(d, instr)
            lat = machine.mfma_cycles(instr)
            # throughput bound: chip retires mce_per_cu*cu_count MFMAs / lat
            op_cycles = cnt * n * lat / (machine.mce_per_cu * machine.cu_count)
            instr_mix[instr] += int(cnt * n)
            out.total_mfma += cnt * n
            n_units = int(cnt * n)
        out.total_cycles += op_cycles
        out.matrix_flops += cnt * d.flops
        out.per_op.append(OpCost(
            label=f"dot[{d.batch}x{d.m}x{d.n}x{d.k}]{d.in_dtype}",
            kind="dot", time_s=op_cycles / clock_hz, count=float(cnt),
            flops=float(cnt * d.flops),
            detail=f"{instr} x{n_units}"))

    out.time_s = out.total_cycles / clock_hz
    out.instr_mix = dict(instr_mix)
    return out


# ---------------------------------------------------------------------------
# Roofline terms
# ---------------------------------------------------------------------------

def bound_time(amount: float, rate: float) -> float:
    """Time to move/compute ``amount`` at ``rate``.

    A spec that omits a bandwidth can't bound traffic it carries: zero
    work is free, nonzero work on a zero-rate resource is infinite.
    """
    if rate <= 0:
        return 0.0 if amount <= 0 else float("inf")
    return amount / rate


def roofline_times(flops: float, nbytes: float, wire_bytes: float,
                   machine: MachineModel) -> Dict[str, float]:
    """The three roofline terms for one module on one machine.

    Peaks and bandwidths come from the machine's backing
    :class:`~repro_torch.arch.DeviceSpec` (overlay scenarios already applied);
    an engine-level ``mfma_scale`` divides the advertised peak, matching
    ``Overlay.apply``'s ``peak_flops`` semantics.
    """
    machine = as_machine(machine)
    spec = machine.spec
    if spec is None:
        raise ValueError(
            f"{machine.name} has no backing DeviceSpec; the roofline needs "
            "bandwidths from the repro_torch.arch registry")
    peak = spec.peak_flops_effective
    if machine.mfma_scale != 1.0:
        peak /= machine.mfma_scale
    links, link_bw = spec.interconnect.links, spec.interconnect.link_bw
    return {
        "compute": bound_time(flops, peak),
        "memory": bound_time(nbytes, spec.memory.hbm_bw),
        "collective": bound_time(wire_bytes, links * link_bw),
        "peak_flops": peak,
    }


# ---------------------------------------------------------------------------
# Tile planning for arbitrary dots (the kernels' tiles)
# ---------------------------------------------------------------------------

def plan_for_dot(machine, d, fallback_dtype: str = "bf16"):
    """The :class:`~repro_torch.kernels.plan.TilePlan` the ``mfma_gemm``
    kernel would execute for one dot on ``machine`` — on the reference's
    devices dims padded to the alignment quantum, exactly modelling padded
    execution; on the H100 the tile the CUDA kernel runs.  Predicted and
    executed tiles can be cross-checked (``Report.plan``).  A dot dtype
    the planner cannot size falls back to ``fallback_dtype``, mirroring
    ``best_instr``; genuine planning failures (e.g. a what-if device
    whose fast memory cannot hold one aligned tile set) propagate as
    ``ValueError``."""
    from repro_torch.kernels.plan import UnknownDtypeError, plan_for
    machine = as_machine(machine)
    shapes = {"M": d.m, "N": d.n, "K": d.k}
    try:
        return plan_for("mfma_gemm", shapes, dtype=d.in_dtype,
                        device=machine, pad=True)
    except UnknownDtypeError:
        return plan_for("mfma_gemm", shapes, dtype=fallback_dtype,
                        device=machine, pad=True)


def plan_for_graph(graph: KernelGraph, machine) -> Optional[Dict]:
    """Plan dict for the module's dominant (most-FLOPs) dot, or None for
    a dot-free / totals-only graph."""
    pairs = graph.dot_pairs()
    if not pairs:
        return None
    d, _ = max(pairs, key=lambda p: p[0].flops * p[1])
    try:
        return plan_for_dot(machine, d).as_dict()
    except ValueError:
        return None


# ---------------------------------------------------------------------------
# The engine protocol + implementations
# ---------------------------------------------------------------------------

class CostEngine(Protocol):
    """What the pipeline needs from a cost model: a name and an estimate."""

    name: str

    def estimate(self, graph: KernelGraph, machine) -> Report:
        """Cost ``graph`` on ``machine`` (MachineModel/DeviceSpec/name)."""
        ...


class RooflineEngine:
    """Bandwidth/peak bound analysis from the device spec."""

    name = "roofline"

    def __init__(self, *, kernel_adjusted: bool = True):
        # kernel-adjusted: flash-attention block intermediates stay on
        # chip in the attention kernels; the plain path materialises them
        self.kernel_adjusted = kernel_adjusted

    def estimate(self, graph: KernelGraph, machine) -> Report:
        machine = as_machine(machine)
        nbytes = graph.bytes_accessed
        if self.kernel_adjusted:
            nbytes -= graph.flash_block_bytes
        t = roofline_times(graph.flops, nbytes, graph.collective_wire,
                           machine)
        total = max(t["compute"], t["memory"], t["collective"])
        bound = max(("compute", t["compute"]), ("memory", t["memory"]),
                    ("collective", t["collective"]), key=lambda kv: kv[1])[0]
        peak, hbm = t["peak_flops"], (machine.spec.memory.hbm_bw
                                      if machine.spec else 0.0)
        links = machine.spec.interconnect if machine.spec else None
        link_rate = links.links * links.link_bw if links else 0.0
        per_op = []
        for op in graph.ops:
            if op.kind == "dot":
                ot = bound_time(op.count * op.flops, peak)
            elif op.kind == "collective":
                ot = bound_time(op.count * op.wire_bytes, link_rate)
            else:
                ot = bound_time(op.count * op.bytes, hbm)
            per_op.append(OpCost(label=op.label, kind=op.kind, time_s=ot,
                                 count=op.count,
                                 flops=float(op.count * op.flops),
                                 bytes=op.count * op.bytes))
        util = 0.0
        if total and not math.isinf(total):
            util = bound_time(graph.flops, peak) / total
        return Report(
            engine=self.name, device=machine.name,
            total_time_s=total,
            compute_time_s=t["compute"], memory_time_s=t["memory"],
            collective_time_s=t["collective"], bound=bound,
            utilization=util, per_op=per_op,
            metrics={"peak_flops": peak, "hbm_bw": hbm,
                     "link_rate": link_rate,
                     "bytes_accessed": nbytes,
                     "collective_wire_bytes": graph.collective_wire})


class MfmaAnalyticEngine:
    """The paper's closed-form MCE/MXU throughput model."""

    name = "mfma"

    def __init__(self, fallback_dtype: str = "bf16"):
        self.fallback_dtype = fallback_dtype

    def estimate(self, graph: KernelGraph, machine) -> Report:
        machine = as_machine(machine)
        _require_matrix_model(machine, self.name)
        costs = cost_dot_pairs(machine, graph.dot_pairs(),
                               fallback_dtype=self.fallback_dtype)
        peak = machine.matrix_flops_per_cycle * machine.clock_mhz * 1e6
        if machine.mxu_count and machine.mfma_scale != 1.0:
            # the MXU cost path scales pass time by mfma_scale but the
            # mxu_count*mxu_dim^2 peak formula can't see it — fold it in
            # here or utilization exceeds 1 under faster-MCE scenarios
            peak /= machine.mfma_scale
        util = 0.0
        if costs.time_s > 0 and peak > 0:
            util = costs.matrix_flops / costs.time_s / peak
        return Report(
            engine=self.name, device=machine.name,
            total_time_s=costs.time_s,
            compute_time_s=costs.time_s, bound="matrix",
            utilization=util, per_op=costs.per_op,
            metrics={"total_mfma": int(costs.total_mfma),
                     "mce_cycles": costs.total_cycles,
                     "matrix_flops": costs.matrix_flops,
                     "mfma_scale": machine.mfma_scale,
                     "instr_mix": costs.instr_mix})


class ScoreboardEngine:
    """Event-driven validation: representative tile loops through the
    NRDY_MATRIX_CORE simulator, extrapolated to the module.

    Per dot, the engine derives the SAME :class:`TilePlan` the
    ``mfma_gemm`` kernel would execute (``plan_for_dot``: dims
    padded to the device's alignment quantum, blocks VMEM-budgeted) and
    simulates a full-occupancy slice of that tile — one WF per MCE, each
    WF's stream its share of the plan tile's MFMA micro-ops (capped at
    ``max_tiles_per_wf``; cycles/MFMA converges well before the cap).
    The measured cycles/MFMA — which include issue overhead the analytic
    model ignores — replace the tabled latency in the throughput
    extrapolation.  MXU (table-less) devices have no instruction stream
    to simulate and fall back to the analytic pass model, flagged in
    ``metrics["simulated"]``.  ``Report.plan`` records the dominant
    dot's plan for cross-checking against the executed tiles.
    """

    name = "scoreboard"

    def __init__(self, *, max_tiles_per_wf: int = 16,
                 fallback_dtype: str = "bf16"):
        self.max_tiles_per_wf = max_tiles_per_wf
        self.fallback_dtype = fallback_dtype
        self._measured: Dict[Tuple, Dict[str, float]] = {}

    def _measure(self, machine: MachineModel, instr: str,
                 plan) -> Dict[str, float]:
        """Measured per-CU throughput for one (instruction, plan tile)
        (memoised on the timing-relevant machine state, so overlay sweeps
        re-simulate only when a knob actually changes the timing).
        ``plan=None`` (unplannable dot) measures a fixed-length stream."""
        blocks = tuple(sorted(plan.blocks.items())) if plan is not None \
            else None
        key = (instr, blocks, machine.mfma_cycles(instr), machine.t_inst,
               machine.simd_per_cu, machine.mce_per_cu)
        hit = self._measured.get(key)
        if hit is not None:
            return hit
        if plan is None:
            out = simulate_gemm_cu(machine, instr,
                                   tiles_per_wf=self.max_tiles_per_wf,
                                   n_wf=machine.mce_per_cu)
            out["tiles_per_wf"] = self.max_tiles_per_wf
            out["cycles_per_mfma_cu"] = out["makespan"] / out["total_mfma"]
        else:
            out = measure_plan_throughput(
                machine, instr, plan,
                max_tiles_per_wf=self.max_tiles_per_wf)
        self._measured[key] = out
        return out

    def estimate(self, graph: KernelGraph, machine) -> Report:
        machine = as_machine(machine)
        _require_matrix_model(machine, self.name)
        if machine.mxu_count or not machine.has_mfma_table:
            # No MFMA instruction stream on MXU devices: analytic pass model.
            rep = MfmaAnalyticEngine(self.fallback_dtype).estimate(
                graph, machine)
            metrics = dict(rep.metrics)
            metrics["simulated"] = 0.0
            return dataclasses.replace(rep, engine=self.name,
                                       metrics=metrics,
                                       plan=plan_for_graph(graph, machine))

        clock_hz = machine.clock_mhz * 1e6
        total_cycles = total_mfma = matrix_flops = 0.0
        util_acc = util_w = 0.0
        best_plan = None
        best_flops = -1.0
        per_op: List[OpCost] = []
        for d, cnt in graph.dot_pairs():
            instr = best_instr(machine, d.in_dtype) or best_instr(machine, {
                "bf16": "bf16", "f16": "f16"}.get(self.fallback_dtype, "f32"))
            if instr is None:
                continue
            try:
                plan = plan_for_dot(machine, d)
            except ValueError:
                plan = None     # unplannable (e.g. tiny what-if VMEM):
                                # degrade to the fixed stream, plan column
                                # stays empty like the other engines
            if plan is not None and cnt * d.flops > best_flops:
                best_flops, best_plan = cnt * d.flops, plan
            n = mfma_count(d, instr)
            meas = self._measure(machine, instr, plan)
            # chip-level: every CU runs the measured stream concurrently
            op_cycles = cnt * n * meas["cycles_per_mfma_cu"] / machine.cu_count
            total_cycles += op_cycles
            total_mfma += cnt * n
            matrix_flops += cnt * d.flops
            util_acc += meas["mce_utilization"] * cnt * n
            util_w += cnt * n
            per_op.append(OpCost(
                label=f"dot[{d.batch}x{d.m}x{d.n}x{d.k}]{d.in_dtype}",
                kind="dot", time_s=op_cycles / clock_hz, count=float(cnt),
                flops=float(cnt * d.flops),
                detail=f"{instr} {meas['cycles_per_mfma_cu']:.1f}cy/mfma"
                       + (f" tile {plan.blocks['block_m']}x"
                          f"{plan.blocks['block_n']}x"
                          f"{plan.blocks['block_k']}" if plan else "")))
        time_s = total_cycles / clock_hz
        return Report(
            engine=self.name, device=machine.name,
            total_time_s=time_s, compute_time_s=time_s, bound="matrix",
            utilization=util_acc / util_w if util_w else 0.0,
            per_op=per_op,
            plan=best_plan.as_dict() if best_plan is not None else None,
            metrics={"total_mfma": int(total_mfma),
                     "mce_cycles": total_cycles,
                     "matrix_flops": matrix_flops,
                     "mfma_scale": machine.mfma_scale,
                     "simulated": 1.0})
