"""Listing-1 microbenchmarks, Eq. 1 latency extraction, and the
representative GEMM tile loops the scoreboard engine measures (twin of
``repro.core.microbench``).

``build_listing1`` reconstructs the paper's inlined-assembly kernel as IR::

    s_waitcnt                  # line 2: lgkmcnt(0) & vmcnt(0)
    [s_nop padding]            # blue-highlighted instructions needed this
    s_memtime  -> start        # line 3
    v_mfma x N (data-dependent chain through D/C)   # lines 4-8
    s_memtime  -> end          # line 9
    s_waitcnt                  # line 10

The MFMAs accumulate in place (``[C] "v"(d)`` in Listing 1), so each reads
the previous one's destination: the chain serialises, the scoreboard holds
each issue for the full MFMA latency, and

    T_total = (N_MFMA - 1) * T_MFMA + T_memtime + T_inst          (paper)
    T_MFMA  = (T_total - T_memtime - T_inst) / (N_MFMA - 1)       (Eq. 1)

As in the paper, the functional output of this stream is intentionally
wrong (no independent work / NOPs between dependent MFMAs) — it is a pure
timing probe.

The same stream runs on the card's tensor cores in
:mod:`repro_torch.kernels.listing1` (``mma.sync`` chains between two
``%clock64`` reads), whose stamps :func:`eq1_latency` reads with a
machine whose ``t_memtime`` is the probe's measured overhead.

:func:`plan_microops` reads only ``plan.blocks``: any object with the
reference planner's ``TilePlan.blocks`` mapping works.  The planner's
twin comes with the perf pipeline (ROADMAP queue 1, item 6b).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Sequence

from repro_torch.core import isa
from repro_torch.core.machine import MachineModel, as_machine
from repro_torch.core.program import (Program, Wavefront, Workload, mfma,
                                s_memtime, s_nop, s_waitcnt)
from repro_torch.core.scoreboard import WFResult, simulate, simulate_program

__all__ = ["build_listing1", "t_total", "eq1_latency", "measure_latency",
           "latency_table", "gemm_stream", "simulate_gemm_cu",
           "plan_microops", "measure_plan_throughput"]


def build_listing1(instr_name: str, n_mfma: int, *, padding_nops: int = 0) -> Program:
    if n_mfma < 2:
        raise ValueError("need >= 2 MFMAs: the final one is not waited on "
                         "(paper Section IV-C)")
    prog: Program = [s_waitcnt()]
    prog += [s_nop() for _ in range(padding_nops)]
    prog.append(s_memtime("s_start", tag="start"))
    for i in range(n_mfma):
        # D = C + A*B with C == D: in-place accumulate => true dep chain.
        prog.append(mfma(instr_name, d="v_d", a="v_a", b="v_b", c="v_d",
                         tag=f"mfma{i}"))
    prog.append(s_memtime("s_end", tag="end"))
    prog.append(s_waitcnt())
    return prog


def t_total(result: WFResult) -> int:
    """total = end - start, as accumulated on line 13 of Listing 1."""
    return result.value("s_end") - result.value("s_start")


def eq1_latency(total: int, n_mfma: int, machine: MachineModel) -> float:
    """Equation 1 of the paper."""
    return (total - machine.t_memtime - machine.t_inst) / (n_mfma - 1)


def measure_latency(machine: MachineModel, instr_name: str, n_mfma: int,
                    *, padding_nops: int = 0) -> float:
    prog = build_listing1(instr_name, n_mfma, padding_nops=padding_nops)
    res = simulate_program(machine, prog)
    return eq1_latency(t_total(res), n_mfma, machine)


def latency_table(machine: MachineModel,
                  instr_names: Optional[Sequence[str]] = None,
                  n_range: Iterable[int] = (2, 3, 4, 5)) -> Dict[str, Dict[int, float]]:
    """Reproduces paper Tables III/V (gem5 columns) for ``machine``.

    Returns {instr: {N: measured_latency}}.  Deterministic, so values match
    the 'Expected' column rather than the KVM-jittered samples.
    """
    if instr_names is None:
        instr_names = machine.supported_instructions(validated_only=True)
    return {name: {n: measure_latency(machine, name, n) for n in n_range}
            for name in instr_names}


# ---------------------------------------------------------------------------
# Representative GEMM tile loops (the scoreboard engine's measurement path)
# ---------------------------------------------------------------------------

def gemm_stream(instr_name: str, n_tiles: int, wf_id: int) -> Program:
    """Independent MFMA tiles for one WF (software-pipelined: no dep chain)."""
    return [mfma(instr_name, d=f"acc{t}", a=f"a{t}", b=f"b{t}", c=f"acc{t}")
            for t in range(n_tiles)]


def simulate_gemm_cu(machine: MachineModel, instr_name: str, *,
                     tiles_per_wf: int = 8, n_wf: int = 8) -> Dict[str, float]:
    """Simulate one CU running a GEMM tile loop across n_wf wavefronts.

    WFs are assigned round-robin to SIMD units; with n_wf >= simd_per_cu the
    analytic throughput (mce_per_cu MFMAs per mfma_cycles) should be reached.
    """
    machine = as_machine(machine)
    wfs = [Wavefront(w, gemm_stream(instr_name, tiles_per_wf, w),
                     cu=0, simd=w % machine.simd_per_cu)
           for w in range(n_wf)]
    res = simulate(machine, Workload(wfs))
    total_mfma = tiles_per_wf * n_wf
    lat = machine.mfma_cycles(instr_name)
    analytic = total_mfma * lat / min(n_wf, machine.mce_per_cu)
    return {"makespan": res.makespan, "analytic_cycles": analytic,
            "mce_utilization": res.mce_utilization(machine),
            "total_mfma": total_mfma}


def plan_microops(plan, instr_name: str) -> int:
    """MFMA micro-ops covering ONE (block_m, block_n, block_k) plan tile.

    ``plan`` is a tile plan for a GEMM-shaped kernel (the reference's
    ``repro.kernels.plan.TilePlan`` or any object with its ``blocks``
    mapping of ``block_m``, ``block_n``, ``block_k``), so the simulated
    stream and the real tile loop cover identical work.
    """
    i = isa.lookup(instr_name)
    b = plan.blocks
    tiles = (math.ceil(b["block_m"] / i.m) * math.ceil(b["block_n"] / i.n)
             * math.ceil(b["block_k"] / i.k))
    return math.ceil(tiles / i.blocks)


def measure_plan_throughput(machine: MachineModel, instr_name: str, plan, *,
                            max_tiles_per_wf: int = 16) -> Dict[str, float]:
    """Measured per-CU throughput for one plan tile at full occupancy.

    One WF per MCE; each WF's stream is its share of the plan tile's
    micro-ops, capped at ``max_tiles_per_wf`` (measured cycles/MFMA
    converges well before that — the cap bounds event-sim cost, not
    fidelity).  Returns the ``simulate_gemm_cu`` dict plus the per-WF
    stream length actually simulated."""
    machine = as_machine(machine)
    n_wf = machine.mce_per_cu
    per_wf = max(1, min(max_tiles_per_wf,
                        math.ceil(plan_microops(plan, instr_name) / n_wf)))
    out = simulate_gemm_cu(machine, instr_name, tiles_per_wf=per_wf,
                           n_wf=n_wf)
    out["tiles_per_wf"] = per_wf
    out["cycles_per_mfma_cu"] = out["makespan"] / out["total_mfma"]
    return out
