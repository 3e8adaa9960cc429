"""PyTorch + CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
module names and contracts and never imports it (nor ``jax``).  It
serves all ten configs of the reference's catalog
(``repro_torch.configs``): the dense ones through the paged
continuous-batching engine (``repro_torch.serve.PagedServeEngine``) and
the sync engine, the MoE, SSM, hybrid and MLA ones through the sync
engine, the cross-attention and encoder-decoder ones through
``repro_torch.models.prefill`` and ``decode_step``; the hand-written
CUDA kernels are in ``repro_torch/csrc``.

Entry points take ``device=`` and default to ``"cuda"``; pass
``device="cpu"`` to run the plain PyTorch versions of the kernels (what
the CPU tests do).
"""

from repro_torch.device import resolve_device  # noqa: F401
