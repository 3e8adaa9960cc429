"""Loop-aware cost analysis — compatibility shim over
``repro_torch.perf.hlo_ir`` (twin of ``repro.core.hlo_analysis``).

Why this exists: XLA:CPU's ``compiled.cost_analysis()`` counts each op ONCE
even inside ``while`` loops — a scanned 60-layer transformer reports 1/60th
of its FLOPs.  The trip-count-aware parser that fixes this now lives in
:func:`repro_torch.perf.hlo_ir.parse_module` (one parser for the whole
performance stack); this module keeps the legacy :class:`HLOStats` result
shape for existing call sites.  New code should use
``repro_torch.perf.parse_cached`` / ``repro_torch.perf.predict`` directly.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Tuple

from repro_torch.core.hlo_bridge import DotOp
from repro_torch.perf.hlo_ir import parse_module

__all__ = ["HLOStats", "analyze"]

_WARNED = False


def _warn_deprecated() -> None:
    global _WARNED
    if not _WARNED:
        _WARNED = True
        warnings.warn(
            "repro_torch.core.hlo_analysis.analyze is deprecated; use "
            "repro_torch.perf.parse_cached (loop-aware KernelGraph) or "
            "repro_torch.perf.predict instead", DeprecationWarning,
            stacklevel=3)


@dataclasses.dataclass
class HLOStats:
    flops: float                      # loop-aware total (per device)
    bytes_accessed: float             # loop-aware kernel-boundary bytes
    dots: List[Tuple[DotOp, float]]   # (dot, executed count)
    collectives: Dict[str, Dict[str, float]]  # kind -> count/result/wire bytes
    bytes_by_opcode: Dict[str, float] = dataclasses.field(default_factory=dict)
    # fusion-boundary bytes of flash-attention block tensors ((..., S, 512)
    # score/prob intermediates), which the attention kernels keep on chip
    # — the roofline reports memory_t with and without them
    # ("kernel-adjusted").
    flash_block_bytes: float = 0.0

    @property
    def collective_wire_bytes(self) -> float:
        return sum(v["wire_bytes"] for v in self.collectives.values())


def analyze(text: str, *, tpu_correct: bool = True) -> HLOStats:
    """Legacy view of :func:`repro_torch.perf.hlo_ir.parse_module`.

    .. deprecated:: use :func:`repro_torch.perf.parse_cached` instead.
    """
    _warn_deprecated()
    g = parse_module(text, tpu_correct=tpu_correct)
    return HLOStats(
        flops=g.flops,
        bytes_accessed=g.bytes_accessed,
        dots=[(op.as_dot(), cnt) for op, cnt in g.dot_pairs()],
        collectives=g.collectives,
        bytes_by_opcode=dict(g.bytes_by_opcode),
        flash_block_bytes=g.flash_block_bytes,
    )
