"""Instruction-stream IR for the MCE timing simulator (twin of
``repro.core.program``).

A ``Program`` is a per-wavefront, in-order list of ``Instr``.  Registers are
symbolic names; the scoreboard tracks readiness per register, mirroring
gem5's register-dependency scoreboard.  The opcode set covers everything the
paper's microbenchmarks and our workload loops need:

  mfma        V_MFMA_* — occupies the SIMD's MCE, dsts ready after latency
  s_memtime   scalar counter probe — blocks the WF, dst = issue cycle
  s_nop       issue-slot filler (the paper's padding)
  s_waitcnt   blocks until outstanding vm/lgkm ops complete
  v_alu       generic VALU op
  v_load      vector memory load (L1D-class latency)
  ds_load     LDS load
  s_load      scalar memory load
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

__all__ = ["Instr", "Program", "Wavefront", "Workload",
           "mfma", "s_memtime", "s_nop", "s_waitcnt", "v_alu", "v_load",
           "ds_load", "s_load"]


@dataclasses.dataclass(frozen=True)
class Instr:
    opcode: str
    dsts: Tuple[str, ...] = ()
    srcs: Tuple[str, ...] = ()
    mfma_name: Optional[str] = None   # for opcode == "mfma"
    tag: Optional[str] = None         # free-form label for result lookup


def mfma(name: str, d: str, a: str, b: str, c: str, *, tag: str = None) -> Instr:
    """D = C + A*B; reads a, b, c, writes d (paper Section III)."""
    return Instr("mfma", dsts=(d,), srcs=(a, b, c), mfma_name=name, tag=tag)


def s_memtime(dst: str, *, tag: str = None) -> Instr:
    return Instr("s_memtime", dsts=(dst,), tag=tag)


def s_nop(n: int = 0) -> Instr:
    del n  # gem5 models s_nop 0..n uniformly at issue granularity
    return Instr("s_nop")


def s_waitcnt() -> Instr:
    return Instr("s_waitcnt")


def v_alu(d: str, *srcs: str) -> Instr:
    return Instr("v_alu", dsts=(d,), srcs=tuple(srcs))


def v_load(d: str, *, tag: str = None) -> Instr:
    return Instr("v_load", dsts=(d,), tag=tag)


def ds_load(d: str) -> Instr:
    return Instr("ds_load", dsts=(d,))


def s_load(d: str) -> Instr:
    return Instr("s_load", dsts=(d,))


Program = List[Instr]


@dataclasses.dataclass
class Wavefront:
    wf_id: int
    program: Program
    cu: int = 0
    simd: int = 0          # which SIMD unit (hence which MCE) hosts this WF


@dataclasses.dataclass
class Workload:
    wavefronts: List[Wavefront]

    @classmethod
    def single(cls, program: Program, *, cu: int = 0, simd: int = 0) -> "Workload":
        return cls([Wavefront(0, program, cu=cu, simd=simd)])
