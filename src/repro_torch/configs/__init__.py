"""Architecture registry (twin of ``repro.configs``).

``get_config(name)`` returns the published config from the module named
after the architecture.  Ported so far: ``qwen2-7b`` (dense GQA),
``qwen3-moe-235b-a22b`` (GQA with MoE FFNs), ``mamba2-370m`` (SSM
mixers only) and ``jamba-v0.1-52b`` (SSM and attention mixers, dense and
MoE FFNs); the rest of the reference's catalog arrives with the layer
kinds it needs (ROADMAP queue 1).
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "get_config"]

ARCHS = ["qwen2-7b", "qwen3-moe-235b-a22b", "mamba2-370m",
         "jamba-v0.1-52b"]


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown or not yet ported architecture {arch!r}; "
                       f"ported: {ARCHS}")
    mod = importlib.import_module("repro_torch.configs." + arch.replace("-", "_")
                                  .replace(".", "_"))
    return mod.CONFIG
