"""Functional semantics of MFMA instructions: D = C + A @ B, blocked
(twin of ``repro.core.functional``).

The oracle of the paper's functional implementation of the V_MFMA_*
instructions; ``kernels.mfma_gemm`` computes the same contract at GEMM
scale, and composing :func:`mfma_apply` over a GEMM's 16x16 tiles must
give the kernel's result.

The contract is the reference's: A and B are cast to the instruction's
operand type, then both to the output type before the product, and the
product is accumulated in the output type (fp32, fp64 or i32, the MCE's
wide accumulator).  i8 instructions accumulate exactly into int32.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from repro_torch.core import isa
from repro_torch.device import resolve_device

__all__ = ["operand_dtypes", "mfma_apply", "random_operands"]

_DTYPES = {
    "fp64": torch.float64,
    "fp32": torch.float32,
    "fp16": torch.float16,
    "bf16": torch.bfloat16,
    "i8": torch.int8,
    "i32": torch.int32,
    "fp8": torch.float8_e4m3fn,
}

Operand = Union[torch.Tensor, np.ndarray]


def operand_dtypes(instr_name: str) -> Tuple[torch.dtype, torch.dtype]:
    """(operand type of A and B, type of C and D) of an instruction."""
    i = isa.lookup(instr_name)
    return _DTYPES[i.in_dtype], _DTYPES[i.out_dtype]


def _as(x: Operand, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(dtype).to(device)


def mfma_apply(instr_name: str, a: Operand, b: Operand, c: Operand, *,
               device: Union[str, torch.device, None] = "cuda"
               ) -> torch.Tensor:
    """Execute one MFMA instruction functionally.

    a: (blocks, M, K)   b: (blocks, K, N)   c: (blocks, M, N) -> d like c,
    in the instruction's output type.  Tensors keep their device;
    numpy arrays are placed on ``device`` (default ``"cuda"``, which
    raises without a GPU).  All operands must end up on one device.
    Raises ``ValueError`` when a shape is not the instruction's.
    """
    i = isa.lookup(instr_name)
    in_dt, out_dt = operand_dtypes(instr_name)
    tensors = [x for x in (a, b, c) if isinstance(x, torch.Tensor)]
    devices = {x.device for x in tensors}
    if len(tensors) < 3:
        devices.add(resolve_device(device))
    if len(devices) > 1:
        raise ValueError(f"mfma_apply({instr_name}): operands on several "
                         f"devices: {sorted(str(d) for d in devices)}")
    dev = resolve_device(devices.pop())     # pins TF32 off on a GPU
    a, b, c = _as(a, in_dt, dev), _as(b, in_dt, dev), _as(c, out_dt, dev)
    for what, got, want in (("a", a.shape, i.a_shape), ("b", b.shape,
                            i.b_shape), ("c", c.shape, i.d_shape)):
        if tuple(got) != want:
            raise ValueError(f"mfma_apply({instr_name}): {what} has shape "
                             f"{tuple(got)}, the instruction takes {want}")
    if i.out_dtype == "i32":
        # CUDA has no integer matmul, so the product is formed in float64
        # on every device.  It is exact: each |a b| <= 128 * 128 = 2**14,
        # so |A @ B| <= K * 2**14 <= 2**19 for K <= 32, far below 2**53.
        prod = torch.bmm(a.double(), b.double()).to(torch.int32)
    else:
        prod = torch.bmm(a.to(out_dt), b.to(out_dt))
    return c + prod


def random_operands(instr_name: str, seed: int = 0,
                    device: Union[str, torch.device, None] = "cuda"
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(a, b, c) for ``instr_name`` drawn from ``np.random.RandomState(
    seed)`` exactly as the reference draws them, so both packages get the
    same operands; on ``device`` (default ``"cuda"``)."""
    i = isa.lookup(instr_name)
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    in_dt, out_dt = operand_dtypes(instr_name)
    if i.in_dtype == "i8":
        a = rng.randint(-4, 4, size=i.a_shape).astype(np.int8)
        b = rng.randint(-4, 4, size=i.b_shape).astype(np.int8)
        c = rng.randint(-8, 8, size=i.d_shape).astype(np.int32)
    else:
        a = rng.randn(*i.a_shape).astype(np.float32)
        b = rng.randn(*i.b_shape).astype(np.float32)
        c = rng.randn(*i.d_shape).astype(np.float32)
    return _as(a, in_dt, dev), _as(b, in_dt, dev), _as(c, out_dt, dev)
