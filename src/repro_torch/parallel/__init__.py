"""Distribution layer (twin of ``repro.parallel``): mesh axes and sharding
rules on ``DeviceMesh``/DTensor (:mod:`~repro_torch.parallel.api`), the
int8 gradient all-reduce (:mod:`~repro_torch.parallel.compression`) and
the GPipe schedule (:mod:`~repro_torch.parallel.pipeline`)."""

from repro_torch.parallel.api import (AxisSpec, current_axes,  # noqa: F401
                                      current_mesh, logical_to_spec,
                                      set_mesh, shard)
