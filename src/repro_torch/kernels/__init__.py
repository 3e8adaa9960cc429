"""The port's hand-written Hopper kernels, their plain PyTorch versions
and oracles.

Ported so far: ``paged_decode_attention`` (CUDA C++, ``csrc/``).  The
reference's other Pallas kernels are still to port (ROADMAP queue 2).
"""

from typing import Dict

from repro_torch.kernels.decode_attention import (  # noqa: F401
    LAUNCHES as _PAGED_DECODE_LAUNCHES, paged_decode_attention,
    paged_decode_attention_plain)

__all__ = ["paged_decode_attention", "paged_decode_attention_plain",
           "launch_counts", "reset_launch_counts"]

_COUNTERS = (_PAGED_DECODE_LAUNCHES,)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    out: Dict[str, int] = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] = 0
