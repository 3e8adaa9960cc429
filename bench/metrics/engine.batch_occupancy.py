"""Mean ACTIVE slots per decode step in the window, over ``max_batch``
(a slot is ACTIVE once its prompt is prefilled: its cache length is
above 0)."""

import numpy as np


def read(run):
    steps = [s for s in run.decodes if s.in_window]
    if not steps:
        return None
    B = run.workload["engine"]["max_batch"]
    return 100.0 * float(np.mean([np.count_nonzero(s.lens) for s in steps])) / B
