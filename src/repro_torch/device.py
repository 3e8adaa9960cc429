"""Device resolution for the port's entry points.

Every entry point takes ``device=`` (default ``"cuda"``) and resolves it
here.  Asking for CUDA on a machine without it raises instead of
quietly running on the CPU: a number measured on the CPU must never pass
for a GPU one.

Resolving a CUDA device also switches TF32 off for both cuBLAS matmuls
and cuDNN, and forbids reduced-precision (bf16/fp16) split-K reductions
in cuBLAS.  The reference accumulates every matmul in full f32
(``preferred_element_type=float32``); TF32 keeps ~3 decimal digits and
would make the port's f32 path disagree with it by far more than
reduction order does.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]


def _pin_cuda_numerics() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``.  A
    CUDA device comes back with its index (``"cuda"`` becomes the current
    device, e.g. ``cuda:0``), so it compares equal to a tensor's device.

    Raises ``RuntimeError`` when CUDA is asked for and absent.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                f"is False (torch {torch.__version__}, built for CUDA "
                f"{torch.version.cuda}); pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        _pin_cuda_numerics()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device {str(dev)!r}: the port runs on 'cuda' or "
                         "'cpu' only")
    return dev
