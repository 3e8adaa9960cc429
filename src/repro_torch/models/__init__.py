"""Model layers and the paged serving steps (twin of ``repro.models``)."""

from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.model import (init_params,  # noqa: F401
                                      paged_decode_step, paged_prefill_step)
