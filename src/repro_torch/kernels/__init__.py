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

The four kernels with a logical-axis contract run sharded on a mesh
when an operand is a DTensor (:mod:`repro_torch.kernels.sharded`),
counted in :func:`sharded_launch_counts`.  The tile planner's names
(``plan_for``, ``TilePlan``, the kernel catalog) are re-exported from
:mod:`repro_torch.kernels.plan`, as the reference's package does.
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
from repro_torch.kernels.plan import (  # noqa: F401
    KernelEntry, TilePlan, UnknownKernelError, get_kernel, list_kernels,
    plan_for, register_kernel)
from repro_torch.kernels.sharded import SHARDED_LAUNCHES as _SHARDED

__all__ = ["flash_attention", "flash_attention_plain", "decode_attention",
           "decode_attention_plain", "paged_decode_attention",
           "paged_decode_attention_plain", "moe_gmm", "moe_gmm_plain",
           "mamba2_ssd", "mamba2_ssd_plain", "mfma_gemm", "mfma_gemm_plain",
           "listing1", "listing1_plain", "launch_counts", "reset_launch_counts",
           "sharded_launch_counts", "KernelEntry", "TilePlan",
           "UnknownKernelError", "get_kernel", "list_kernels", "plan_for",
           "register_kernel"]

_COUNTERS = (_FLASH_LAUNCHES, _DECODE_LAUNCHES, _MOE_GMM_LAUNCHES,
             _SSD_LAUNCHES, _MFMA_GEMM_LAUNCHES, _LISTING1_LAUNCHES)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    out: Dict[str, int] = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def sharded_launch_counts() -> Dict[str, int]:
    """Shard bodies run through the sharded path since the last reset, by
    kernel name (one a rank a call)."""
    return dict(_SHARDED)


def reset_launch_counts() -> None:
    """Zero every launch count, the sharded path's too."""
    for c in _COUNTERS + (_SHARDED,):
        for k in c:
            c[k] = 0
