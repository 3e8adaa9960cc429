"""`DeviceSpec`: the declarative device-capability schema (twin of
``repro.arch.spec``).

One frozen, data-only description per accelerator: compute topology,
per-instruction MFMA cycle tables with ``validated`` provenance, the
memory hierarchy (latencies and bandwidths), the interconnect, clocks
and the advertised peak FLOP/s.  The schema, its defaults and its
helpers are the reference's, field for field; the port's catalog
(:mod:`repro_torch.arch.registry`) fills it for the H100.

Specs are immutable; variants are expressed as *deltas* via
:meth:`DeviceSpec.derive`.  Instruction metadata comes from
:mod:`repro_torch.core.isa`, imported lazily at call time.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

__all__ = [
    "CycleEntry",
    "MemoryHierarchy",
    "Interconnect",
    "DeviceSpec",
    "UnknownDeviceError",
    "scale_cycles",
    "matrix_peak_flops_per_cycle",
]


def _isa():
    # Lazy, as in the reference: instruction metadata is looked up at call
    # time, so importing the spec never pulls the instruction registry in.
    from repro_torch.core import isa
    return isa


#: Canonical dense-ML instruction anchoring GPU peak-throughput math.
CANONICAL_DENSE_INSTR = "fp32_16x16x16fp16"


def scale_cycles(cycles: int, scale: float) -> int:
    """The gem5 what-if rounding rule: multiply, round, clamp to >= 1.

    The ONE home of this contract — cycle-table scaling, memory-latency
    scaling, and machine-level overlays must all round identically or
    spec-level and machine-level scenarios drift apart.
    """
    if scale == 1.0:
        return cycles
    return max(1, int(round(cycles * scale)))


def matrix_peak_flops_per_cycle(*, mxu_count: int, mxu_dim: int,
                                cu_count: int, mce_per_cu: int,
                                canonical_cycles: Optional[int]) -> float:
    """Whole-chip peak matrix FLOPs/cycle — the ONE home of the formula.

    MXU devices: systolic-array throughput.  GPU devices: one
    ``CANONICAL_DENSE_INSTR`` per MCE per ``canonical_cycles``.
    In the reference both ``DeviceSpec`` and the machine model call this
    with their own (possibly tweaked) values.
    """
    if mxu_count:
        return 2.0 * mxu_count * mxu_dim * mxu_dim
    flops = _isa().lookup(CANONICAL_DENSE_INSTR).flops
    return flops * cu_count * mce_per_cu / canonical_cycles


class UnknownDeviceError(KeyError):
    """Raised when a device name is not in the registry.

    Subclasses :class:`KeyError` so ``except KeyError`` call sites keep
    working.
    """


@dataclasses.dataclass(frozen=True)
class CycleEntry:
    """One row of a per-device MFMA timing table.

    ``validated=True`` entries are the paper's Tables II-V "Expected"
    column (cross-checked on real MI210/MI300 hardware); ``False`` entries
    follow the ISA-manual latency-class pattern, or were inherited onto a
    derived device whose silicon has not been measured.
    """

    cycles: int
    validated: bool = False


@dataclasses.dataclass(frozen=True)
class MemoryHierarchy:
    """Latencies in core cycles (paper Table I) + bandwidths in bytes/s."""

    l1i_latency: int = 40
    l1d_latency: int = 140
    scalar_latency: int = 41
    lds_latency: int = 65
    l2_latency: int = 269
    mem_latency: int = 483
    valu_latency: int = 1
    hbm_bw: float = 0.0          # bytes/s, whole chip
    l2_bw: float = 0.0           # bytes/s, whole chip (0 = unspecified)
    lds_bw: float = 0.0          # bytes/s, whole chip (0 = unspecified)

    def scaled(self, latency_scale: float) -> "MemoryHierarchy":
        """Uniformly scale every *memory* latency (what-if knob).

        ``valu_latency`` is a compute-pipe latency and is deliberately
        untouched — a "slower HBM" scenario must not slow the vector ALU.
        Bandwidths are kept.
        """
        if latency_scale == 1.0:
            return self
        return dataclasses.replace(
            self,
            **{f: scale_cycles(getattr(self, f), latency_scale)
               for f in ("l1i_latency", "l1d_latency", "scalar_latency",
                         "lds_latency", "l2_latency", "mem_latency")})


@dataclasses.dataclass(frozen=True)
class Interconnect:
    """Off-chip links as the roofline charges them.

    ``links`` is the number of links a ring collective drives
    *concurrently* (2 for a bidirectional ring on one torus dimension),
    not the physical port count; ``link_bw`` is per-link bytes/s.
    """

    links: int = 1
    link_bw: float = 0.0


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Full capability description of one accelerator."""

    name: str
    family: str = ""              # e.g. "amd-cdna2", "google-tpu"
    clock_mhz: float = 1000.0
    # -- compute topology (paper Section III / Table I) ------------------
    cu_count: int = 60
    simd_per_cu: int = 4
    mce_per_simd: int = 1
    max_wf_per_simd: int = 10
    wavefront_size: int = 64
    # -- issue / probe calibration (paper Section IV-C) ------------------
    t_inst: int = 4
    t_memtime: int = 40
    # -- TPU-analytic matrix units (0 => MFMA cycle-table device) --------
    mxu_count: int = 0
    mxu_dim: int = 128
    # -- fast on-chip tile budget in bytes (VMEM per TPU core; an L2 /
    #    Infinity-Cache staging slice on cycle-table GPUs; a block's
    #    shared memory on Hopper).  The reference's tile planner sizes
    #    block working sets against this; 0 means "unspecified".
    vmem_bytes: int = 0
    # -- memory + interconnect ------------------------------------------
    memory: MemoryHierarchy = MemoryHierarchy()
    interconnect: Interconnect = Interconnect()
    # -- MFMA timing table: instr name -> CycleEntry ---------------------
    cycle_table: Mapping[str, CycleEntry] = dataclasses.field(
        default_factory=dict)
    # -- advertised peak matrix FLOP/s (0 => derive from the tables) -----
    peak_flops: float = 0.0

    # ------------------------------------------------------------------
    # Topology helpers
    # ------------------------------------------------------------------
    @property
    def mce_per_cu(self) -> int:
        return self.simd_per_cu * self.mce_per_simd

    @property
    def has_cycle_table(self) -> bool:
        return bool(self.cycle_table)

    # ------------------------------------------------------------------
    # Timing table (the paper's mfma_cycles lookup)
    # ------------------------------------------------------------------
    def mfma_cycles(self, name: str, *, mfma_scale: float = 1.0,
                    allow_gpr_idx: bool = False) -> int:
        """Latency in cycles of ``name`` on this device.

        ``mfma_scale`` is the paper's ``--mfma-scale`` what-if parameter:
        the tabled latency is multiplied and rounded, exactly as in gem5.
        """
        isa = _isa()
        instr = isa.lookup(name)
        if instr.gpr_idx_mode and not allow_gpr_idx:
            raise isa.UnsupportedInstructionError(
                f"{name} uses the s_set_gpr_idx addressing mode, which the "
                "gem5-parity timing model does not support "
                "(paper Section VI)")
        if not self.has_cycle_table:
            raise isa.UnsupportedInstructionError(
                f"{self.name} has no MFMA cycle table; "
                "use the analytic MXU path")
        entry = self.cycle_table.get(name)
        if entry is None:
            raise isa.UnsupportedInstructionError(
                f"{name} is not supported on {self.name} "
                "(e.g. i32_16x16x16i8 was removed on MI300)")
        return scale_cycles(entry.cycles, mfma_scale)

    def supported_instructions(self, *, validated_only: bool = False
                               ) -> Sequence[str]:
        isa = _isa()
        out = []
        for name, entry in self.cycle_table.items():
            if validated_only and not entry.validated:
                continue
            if isa.lookup(name).gpr_idx_mode:
                continue
            out.append(name)
        return out

    def supports(self, name: str) -> bool:
        isa = _isa()
        try:
            self.mfma_cycles(name)
            return True
        except isa.UnsupportedInstructionError:
            return False

    # ------------------------------------------------------------------
    # Analytic peaks (HLO bridge / roofline)
    # ------------------------------------------------------------------
    def matrix_flops_per_cycle_at(self, mfma_scale: float = 1.0) -> float:
        """Peak matrix-unit FLOPs per cycle for the whole chip.

        ``mfma_scale`` reaches the GPU cycle lookup; the MXU path is
        throughput-fixed per pass (the what-if applies to pass time in
        the bridge instead).
        """
        cyc = None if self.mxu_count else self.mfma_cycles(
            CANONICAL_DENSE_INSTR, mfma_scale=mfma_scale)
        return matrix_peak_flops_per_cycle(
            mxu_count=self.mxu_count, mxu_dim=self.mxu_dim,
            cu_count=self.cu_count, mce_per_cu=self.mce_per_cu,
            canonical_cycles=cyc)

    @property
    def matrix_flops_per_cycle(self) -> float:
        return self.matrix_flops_per_cycle_at()

    @property
    def peak_matrix_tflops(self) -> float:
        return self.matrix_flops_per_cycle * self.clock_mhz * 1e6 / 1e12

    @property
    def peak_flops_effective(self) -> float:
        """Advertised peak FLOP/s when known, else the derived peak."""
        return self.peak_flops or self.peak_matrix_tflops * 1e12

    # ------------------------------------------------------------------
    # Variant construction (the registry's delta mechanism)
    # ------------------------------------------------------------------
    def derive(self, name: str, *,
               table_patches: Optional[Mapping[str, int]] = None,
               table_remove: Sequence[str] = (),
               table_add: Optional[Mapping[str, Tuple[int, bool]]] = None,
               revalidate: bool = True,
               **overrides) -> "DeviceSpec":
        """A new spec expressed as a delta of this one.

        ``table_patches`` replaces cycle counts for existing instructions,
        ``table_remove`` drops instructions, ``table_add`` maps new
        instruction names to ``(cycles, validated)``.  With
        ``revalidate=False`` every inherited entry is marked
        ``validated=False`` — the right provenance for a derived device
        whose silicon has not been measured against the paper's tables.
        """
        table: Dict[str, CycleEntry] = {}
        for instr, entry in self.cycle_table.items():
            if instr in table_remove:
                continue
            cycles = entry.cycles
            validated = entry.validated and revalidate
            if table_patches and instr in table_patches:
                cycles, validated = table_patches[instr], False
            table[instr] = CycleEntry(cycles, validated)
        if table_patches:
            for instr in table_patches:
                if instr not in table and instr not in table_remove:
                    table[instr] = CycleEntry(table_patches[instr], False)
        if table_add:
            for instr, (cycles, validated) in table_add.items():
                table[instr] = CycleEntry(cycles, validated)
        mem_over = {k: overrides.pop(k) for k in list(overrides)
                    if hasattr(MemoryHierarchy, k) and
                    k in MemoryHierarchy.__dataclass_fields__}
        ic_over = {k: overrides.pop(k) for k in list(overrides)
                   if k in Interconnect.__dataclass_fields__}
        memory = dataclasses.replace(self.memory, **mem_over) \
            if mem_over else self.memory
        interconnect = dataclasses.replace(self.interconnect, **ic_over) \
            if ic_over else self.interconnect
        return dataclasses.replace(
            self, name=name, cycle_table=table, memory=memory,
            interconnect=interconnect, **overrides)
