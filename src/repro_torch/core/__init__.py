"""The paper's MFMA contract (twin of ``repro.core``): the instruction
registry (:mod:`repro_torch.core.isa`) and one instruction executed
functionally (:mod:`repro_torch.core.functional`).

The reference's timing modules (``machine``, ``scoreboard``,
``microbench``, ``whatif``, ``hlo_bridge``) have no twin yet; they come
with the perf front-end (ROADMAP queue 1).
"""
