"""Model layers, the training loss, the sync serving steps and the paged
serving steps (twin of ``repro.models``)."""

from repro_torch.models.config import (CrossAttnSpec,  # noqa: F401
                                       EncoderSpec, MLASpec, ModelConfig,
                                       MoESpec, SSMSpec)
from repro_torch.models.model import (decode_step, forward,  # noqa: F401
                                      init_cache, init_params, loss_fn,
                                      paged_decode_step, paged_prefill_step,
                                      param_logical_axes, prefill)
