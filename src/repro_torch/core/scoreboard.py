"""Event-driven CU/SIMD/MCE timing simulator (the paper's gem5 additions;
twin of ``repro.core.scoreboard``).

Semantics modelled, per paper Section III:

* 1 MCE per SIMD unit, ``simd_per_cu`` SIMD units per CU.  A per-SIMD
  ``NRDY_MATRIX_CORE`` counter holds the cycle until which that SIMD's MCE
  is busy; the scoreboard check refuses to issue an MFMA before it drains.
  This enforces (a) no two concurrent MFMAs on one SIMD — from the same WF
  *or* different WFs — and (b) no intra-WF MFMA pipelining (the observed
  AMD compiler behaviour the paper models).
* Wavefronts issue in order.  An instruction issues at::

      max(operands_ready, fu_available, wf_earliest_issue)

  where ``wf_earliest_issue`` is the previous instruction's issue cycle +
  ``t_inst`` (the calibrated 4-cycle issue overhead), except after a
  *blocking* scalar op (``s_memtime``, ``s_waitcnt``) where it is that op's
  completion cycle.
* Non-MCE work (VALU, memory, scalar) proceeds concurrently with a busy
  MCE, provided it has no true data dependency on the MFMA destination —
  exactly the independent-work/NOP discussion in the paper.
* ``s_memtime`` returns the cycle counter at issue and blocks the WF for
  ``t_memtime`` cycles (the scalar-cache access).  With this convention the
  paper's Listing-1 microbenchmark measures
  ``T_total = (N-1) * T_MFMA + T_memtime + T_inst`` and Eq. 1 recovers the
  per-instruction latency exactly.

Arbitration between WFs competing for one MCE is oldest-first (lowest
wf_id), matching gem5's ordered scoreboard walk; the simulator is fully
deterministic (no KVM jitter), so reproduced tables match the paper's
"Expected" column.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from repro_torch.core.machine import MachineModel, as_machine
from repro_torch.core.program import Instr, Wavefront, Workload

__all__ = ["SimResult", "WFResult", "simulate", "simulate_program"]

_BLOCKING = {"s_memtime", "s_waitcnt"}


@dataclasses.dataclass
class IssueRecord:
    wf_id: int
    index: int
    opcode: str
    issue: int
    complete: int
    tag: Optional[str] = None


@dataclasses.dataclass
class WFResult:
    wf_id: int
    records: List[IssueRecord]
    regs: Dict[str, int]           # final symbolic register values (timestamps)
    finish: int

    def value(self, reg: str) -> int:
        return self.regs[reg]

    def by_tag(self, tag: str) -> IssueRecord:
        for r in self.records:
            if r.tag == tag:
                return r
        raise KeyError(tag)


@dataclasses.dataclass
class SimResult:
    wf: Dict[int, WFResult]
    makespan: int
    mce_busy: Dict[Tuple[int, int], int]        # (cu, simd) -> busy cycles
    stall_cycles: Dict[str, int]                # reason -> total stall cycles

    def mce_utilization(self, machine: MachineModel) -> float:
        if self.makespan == 0:
            return 0.0
        total = sum(self.mce_busy.values())
        n_mce = max(1, len(self.mce_busy))
        return total / (n_mce * self.makespan)


def _latency(machine: MachineModel, instr: Instr) -> int:
    op = instr.opcode
    if op == "mfma":
        return machine.mfma_cycles(instr.mfma_name)
    if op == "s_memtime":
        return machine.t_memtime
    if op == "v_alu":
        return machine.valu_latency
    if op == "v_load":
        return machine.l1d_latency
    if op == "ds_load":
        return machine.lds_latency
    if op == "s_load":
        return machine.scalar_latency
    if op in ("s_nop", "s_waitcnt"):
        return 0
    raise ValueError(f"unknown opcode {op!r}")


def simulate(machine, workload: Workload) -> SimResult:
    """Run every wavefront to completion; returns per-WF timing + stats.

    ``machine`` may be a :class:`MachineModel`, a
    :class:`repro_torch.arch.DeviceSpec`, or a registered device name —
    any device in the ``repro_torch.arch`` registry simulates without
    further glue.
    """
    machine = as_machine(machine)
    # Per-(cu, simd) MCE availability — the NRDY_MATRIX_CORE counters.
    nrdy_matrix_core: Dict[Tuple[int, int], int] = defaultdict(int)
    mce_busy: Dict[Tuple[int, int], int] = defaultdict(int)
    stalls: Dict[str, int] = defaultdict(int)

    @dataclasses.dataclass
    class _WFState:
        wf: Wavefront
        pc: int = 0
        earliest: int = 0                 # earliest next issue cycle
        last_issue: int = -(10 ** 9)
        regs_ready: Dict[str, int] = dataclasses.field(default_factory=dict)
        regs_value: Dict[str, int] = dataclasses.field(default_factory=dict)
        outstanding: List[int] = dataclasses.field(default_factory=list)
        records: List[IssueRecord] = dataclasses.field(default_factory=list)

    states = {w.wf_id: _WFState(wf=w) for w in workload.wavefronts}
    for st in states.values():
        key = (st.wf.cu, st.wf.simd)
        mce_busy.setdefault(key, 0)

    # Event loop: (candidate_time, wf_id).  We pop the WF that can attempt
    # an issue earliest; ties break oldest-first (lowest wf_id), matching
    # the ordered scoreboard walk in gem5.
    heap: List[Tuple[int, int]] = [(0, wf_id) for wf_id in sorted(states)]
    heapq.heapify(heap)

    while heap:
        t_candidate, wf_id = heapq.heappop(heap)
        st = states[wf_id]
        if st.pc >= len(st.wf.program):
            continue
        instr = st.wf.program[st.pc]
        key = (st.wf.cu, st.wf.simd)

        # 1. operand readiness (true data dependencies)
        ops_ready = 0
        for r in instr.srcs:
            ops_ready = max(ops_ready, st.regs_ready.get(r, 0))
        # 2. WAW/WAR on destinations (in-order WF => only WAW matters)
        for r in instr.dsts:
            ops_ready = max(ops_ready, st.regs_ready.get(r, 0))
        # 3. functional-unit availability
        fu_ready = t_candidate
        if instr.opcode == "mfma":
            fu_ready = max(fu_ready, nrdy_matrix_core[key])
        if instr.opcode == "s_waitcnt":
            # drain all outstanding tracked ops for this WF
            if st.outstanding:
                fu_ready = max(fu_ready, max(st.outstanding))

        issue = max(st.earliest, ops_ready, fu_ready, t_candidate)
        if issue > t_candidate:
            # Not ready yet at candidate time: requeue at the real time.
            if ops_ready > t_candidate:
                stalls["data_dependency"] += ops_ready - t_candidate
            if instr.opcode == "mfma" and nrdy_matrix_core[key] > t_candidate:
                stalls["nrdy_matrix_core"] += nrdy_matrix_core[key] - t_candidate
            heapq.heappush(heap, (issue, wf_id))
            continue

        lat = _latency(machine, instr)
        complete = issue + lat

        if instr.opcode == "mfma":
            nrdy_matrix_core[key] = complete      # MCE busy until done
            mce_busy[key] += lat
        if instr.opcode == "s_memtime":
            # dst = cycle counter sampled at issue
            for d in instr.dsts:
                st.regs_value[d] = issue
                st.regs_ready[d] = complete
        else:
            for d in instr.dsts:
                st.regs_ready[d] = complete
                st.regs_value[d] = complete
        if instr.opcode in ("v_load", "ds_load", "s_load"):
            st.outstanding.append(complete)

        st.records.append(IssueRecord(wf_id, st.pc, instr.opcode, issue,
                                      complete, tag=instr.tag))
        # Next-issue rule: blocking scalar ops hold the WF to completion.
        if instr.opcode in _BLOCKING:
            st.earliest = complete
        else:
            st.earliest = issue + machine.t_inst
        st.last_issue = issue
        st.pc += 1
        if st.pc < len(st.wf.program):
            heapq.heappush(heap, (st.earliest, wf_id))

    results: Dict[int, WFResult] = {}
    makespan = 0
    for wf_id, st in states.items():
        finish = max((r.complete for r in st.records), default=0)
        makespan = max(makespan, finish)
        results[wf_id] = WFResult(wf_id, st.records, dict(st.regs_value), finish)
    return SimResult(wf=results, makespan=makespan,
                     mce_busy=dict(mce_busy), stall_cycles=dict(stalls))


def simulate_program(machine: MachineModel, program, **kw) -> WFResult:
    res = simulate(machine, Workload.single(program, **kw))
    return res.wf[0]
