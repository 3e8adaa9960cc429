"""Data pipeline: the synthetic LM token stream with host prefetch
(twin of ``repro.data``)."""

from repro_torch.data.pipeline import (SyntheticLM,  # noqa: F401
                                       prefetch_to_device)
