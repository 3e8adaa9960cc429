"""PyTorch + CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
module names and contracts and never imports it (nor ``jax``).  The
main path so far is the dense GQA decoder served by the paged
continuous-batching engine: ``repro_torch.serve.PagedServeEngine`` over
``repro_torch.models`` with the hand-written CUDA paged-decode kernel in
``repro_torch/csrc``.

Entry points take ``device=`` and default to ``"cuda"``; pass
``device="cpu"`` to run the plain PyTorch versions of the kernels (what
the CPU tests do).
"""

from repro_torch.device import resolve_device  # noqa: F401
