"""The port's hand-written Hopper kernels, their plain PyTorch versions
and oracles.

All six of the reference's TPU kernels are ported (CUDA C++,
``csrc/``): ``flash_attention`` (prefill), ``decode_attention``
(contiguous-cache decode), ``paged_decode_attention`` (paged decode),
``moe_gmm`` (the MoE expert products), ``mamba2_ssd`` (the SSM layers'
chunked scan) and ``mfma_gemm`` (the paper's ``D = C + A @ B`` contract
on the tensor cores).  ``listing1`` is no TPU kernel's twin: it is the
paper's Listing-1 microbenchmark, chained ``mma.sync`` between two
cycle-counter reads, whose stamps Eq. 1 reads
(:mod:`repro_torch.kernels.listing1`).
"""

from typing import Dict

from repro_torch.kernels.decode_attention import (  # noqa: F401
    LAUNCHES as _DECODE_LAUNCHES, decode_attention, decode_attention_plain,
    paged_decode_attention, paged_decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: F401
    LAUNCHES as _FLASH_LAUNCHES, flash_attention, flash_attention_plain)
from repro_torch.kernels.listing1 import (  # noqa: F401
    LAUNCHES as _LISTING1_LAUNCHES, listing1, listing1_plain)
from repro_torch.kernels.mamba2_ssd import (  # noqa: F401
    LAUNCHES as _SSD_LAUNCHES, mamba2_ssd, mamba2_ssd_plain)
from repro_torch.kernels.mfma_gemm import (  # noqa: F401
    LAUNCHES as _MFMA_GEMM_LAUNCHES, mfma_gemm, mfma_gemm_plain)
from repro_torch.kernels.moe_gmm import (  # noqa: F401
    LAUNCHES as _MOE_GMM_LAUNCHES, moe_gmm, moe_gmm_plain)

__all__ = ["flash_attention", "flash_attention_plain", "decode_attention",
           "decode_attention_plain", "paged_decode_attention",
           "paged_decode_attention_plain", "moe_gmm", "moe_gmm_plain",
           "mamba2_ssd", "mamba2_ssd_plain", "mfma_gemm", "mfma_gemm_plain",
           "listing1", "listing1_plain", "launch_counts", "reset_launch_counts"]

_COUNTERS = (_FLASH_LAUNCHES, _DECODE_LAUNCHES, _MOE_GMM_LAUNCHES,
             _SSD_LAUNCHES, _MFMA_GEMM_LAUNCHES, _LISTING1_LAUNCHES)


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
