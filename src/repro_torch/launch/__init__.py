"""Launchers (twin of ``repro.launch``): the production meshes
(:mod:`~repro_torch.launch.mesh`), the sharded meta-device specs of every
(arch x shape) cell (:mod:`~repro_torch.launch.specs`), the dry-run on a
fake process group (:mod:`~repro_torch.launch.dryrun`) and the roofline
over its records (:mod:`~repro_torch.launch.roofline`).

Importing this package changes no environment variable: the reference's
writes its ``XLA_FLAGS`` device count and ``REPRO_CPU_F32_DOTS`` from its
dry-run module, and the port has no counterpart of either (its dry-run
sizes a fake process group instead of forcing host devices).
"""
