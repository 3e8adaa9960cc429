"""Instruction-selection policy: the best matrix instruction per device
(twin of ``repro.arch.select``).

Which MFMA a GEMM of a given operand dtype should use is a *device*
property (it depends on that device's timing table and supported set), not
an HLO-bridge detail: the reference's bridge calls in here, and the
port's will.  A device without a cycle table (the H100, the TPUs) has no
MFMA to pick: :func:`best_mfma` returns ``None`` for it.

Policy: maximise per-MCE throughput (FLOPs per cycle at the tabled
latency); break ties toward larger tiles, which is what rocBLAS-generated
kernels do in practice.
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.arch.spec import DeviceSpec

__all__ = ["HLO_DTYPE_TO_IN", "best_mfma", "best_mfma_for_hlo",
           "throughput_ranking"]

#: HLO/StableHLO element type -> MFMA operand dtype.
HLO_DTYPE_TO_IN: Dict[str, str] = {
    "f64": "fp64", "f32": "fp32", "bf16": "bf16", "f16": "fp16",
    "s8": "i8", "u8": "i8", "f8e4m3fn": "fp8",
}


def _isa():
    from repro_torch.core import isa
    return isa


def best_mfma(spec: DeviceSpec, in_dtype: str, *,
              mfma_scale: float = 1.0) -> Optional[str]:
    """Highest-throughput supported MFMA for an operand dtype, or None."""
    isa = _isa()
    if not spec.has_cycle_table:
        return None
    best, best_key = None, (-1.0, -1)
    for name in spec.supported_instructions():
        inst = isa.lookup(name)
        if inst.in_dtype != in_dtype:
            continue
        cycles = spec.mfma_cycles(name, mfma_scale=mfma_scale)
        # primary: throughput; tie-break: larger tiles (rocBLAS-realistic)
        key = (inst.flops / cycles, inst.macs)
        if key > best_key:
            best, best_key = name, key
    return best


def best_mfma_for_hlo(spec: DeviceSpec, hlo_dtype: str, *,
                      mfma_scale: float = 1.0) -> Optional[str]:
    """`best_mfma` keyed by the HLO element type ("bf16", "f32", ...)."""
    want = HLO_DTYPE_TO_IN.get(hlo_dtype)
    if want is None:
        return None
    return best_mfma(spec, want, mfma_scale=mfma_scale)


def throughput_ranking(spec: DeviceSpec, *, mfma_scale: float = 1.0):
    """All supported instructions sorted by descending throughput —
    the full selection table `best_mfma` picks from (debug/reporting)."""
    isa = _isa()
    rows = []
    for name in spec.supported_instructions():
        inst = isa.lookup(name)
        cycles = spec.mfma_cycles(name, mfma_scale=mfma_scale)
        rows.append((inst.flops / cycles, inst.macs, name, inst.in_dtype))
    rows.sort(reverse=True)
    return [{"name": n, "in_dtype": d, "flops_per_cycle": t, "macs": m}
            for t, m, n, d in rows]
