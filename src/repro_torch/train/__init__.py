"""Training: optimizer, train step, checkpoints, fault tolerance (twin of
``repro.train``)."""

from repro_torch.train.optim import (OptConfig, adamw_update,  # noqa: F401
                                     init_opt_state, lr_schedule)
from repro_torch.train.step import (make_eval_step,  # noqa: F401
                                    make_train_step)
