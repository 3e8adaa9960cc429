"""MFMA instruction registry: the static shape and type metadata of
every V_MFMA_* instruction (twin of ``repro.core.isa``).

Every matrix-core instruction computes ``D = C + A @ B`` where, per
block, ``A`` is MxK, ``B`` is KxN and ``C``/``D`` are MxN; ``blocks``
independent such products execute per instruction.  Instruction names
follow AMD's ``V_MFMA_[out]_[M]x[N]x[K][_Bb]_[in]`` convention,
normalised to e.g. ``fp32_16x16x16fp16`` / ``f32_32x32x4_2b_bf16``.

The registry holds the reference's 17 instructions: the 7 the paper
validates (Tables II-V) and 10 that follow the ISA manual's pattern,
with the ``s_set_gpr_idx`` addressing-mode flag of Section VI.

Left out until the perf front-end is ported (ROADMAP queue 1): the
cycle tables (``MI200_CYCLES``, ``MI300_CYCLES``) and the
``mfma_cycles`` / ``supported_instructions`` lookups, which in the
reference are views over its device registry's timing tables.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

__all__ = [
    "MFMAInstr",
    "UnsupportedInstructionError",
    "MFMA_REGISTRY",
    "lookup",
    "flops_per_instr",
]


class UnsupportedInstructionError(KeyError):
    """Raised for instructions a machine model does not implement.

    Mirrors the paper's Section VI: MFMA instructions that use the
    ``s_set_gpr_idx`` addressing mode (e.g. ``fp32_32x32x8fp16`` and
    ``fp32_32x32x1fp32``) are unsupported in gem5's timing model, and some
    instructions (e.g. ``i32_16x16x16i8``) were removed on MI300.  Also
    raised for unknown instruction names.
    """


@dataclasses.dataclass(frozen=True)
class MFMAInstr:
    """Static metadata for one V_MFMA_* instruction."""

    name: str           # canonical short name, e.g. "fp32_16x16x16fp16"
    out_dtype: str      # accumulator / destination dtype
    in_dtype: str       # A/B operand dtype
    m: int
    n: int
    k: int
    blocks: int = 1
    # Paper Section VI: these require the s_set_gpr_idx addressing mode and
    # are therefore not implemented in the gem5-parity timing model.
    gpr_idx_mode: bool = False

    @property
    def macs(self) -> int:
        """Multiply-accumulates performed by one instruction (per WF)."""
        return self.m * self.n * self.k * self.blocks

    @property
    def flops(self) -> int:
        return 2 * self.macs

    @property
    def d_shape(self) -> Tuple[int, int, int]:
        return (self.blocks, self.m, self.n)

    @property
    def a_shape(self) -> Tuple[int, int, int]:
        return (self.blocks, self.m, self.k)

    @property
    def b_shape(self) -> Tuple[int, int, int]:
        return (self.blocks, self.k, self.n)


def _I(name, out, inp, m, n, k, blocks=1, gpr_idx=False) -> MFMAInstr:
    return MFMAInstr(name=name, out_dtype=out, in_dtype=inp, m=m, n=n, k=k,
                     blocks=blocks, gpr_idx_mode=gpr_idx)


#: All instructions the framework knows about.
MFMA_REGISTRY: Dict[str, MFMAInstr] = {
    i.name: i
    for i in [
        # --- paper-validated set (Tables II-V) -------------------------
        _I("fp64_16x16x4fp64", "fp64", "fp64", 16, 16, 4),
        _I("fp32_4x4x1fp32", "fp32", "fp32", 4, 4, 1, blocks=16),
        _I("fp32_16x16x4fp32", "fp32", "fp32", 16, 16, 4),
        _I("fp32_16x16x16fp16", "fp32", "fp16", 16, 16, 16),
        _I("i32_16x16x16i8", "i32", "i8", 16, 16, 16),
        _I("fp64_4x4x4fp64", "fp64", "fp64", 4, 4, 4, blocks=4),
        _I("fp32_4x4x4fp16", "fp32", "fp16", 4, 4, 4, blocks=16),
        # --- ISA-manual-pattern extensions (unvalidated timing class) --
        _I("fp32_32x32x2fp32", "fp32", "fp32", 32, 32, 2),
        _I("fp32_32x32x8fp16", "fp32", "fp16", 32, 32, 8, gpr_idx=True),
        _I("fp32_32x32x1fp32", "fp32", "fp32", 32, 32, 1, blocks=2, gpr_idx=True),
        _I("fp32_32x32x4bf16", "fp32", "bf16", 32, 32, 4),
        _I("f32_32x32x4_2b_bf16", "fp32", "bf16", 32, 32, 4, blocks=2),
        _I("fp32_16x16x16bf16", "fp32", "bf16", 16, 16, 16),
        _I("fp32_16x16x8bf16", "fp32", "bf16", 16, 16, 8),
        _I("i32_16x16x32i8", "i32", "i8", 16, 16, 32),
        _I("i32_32x32x16i8", "i32", "i8", 32, 32, 16),
        _I("fp32_16x16x32fp8", "fp32", "fp8", 16, 16, 32),
    ]
}


def lookup(name: str) -> MFMAInstr:
    try:
        return MFMA_REGISTRY[name]
    except KeyError as e:
        raise UnsupportedInstructionError(f"unknown MFMA instruction {name!r}") from e


def flops_per_instr(name: str) -> int:
    return lookup(name).flops
