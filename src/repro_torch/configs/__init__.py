"""Architecture registry (twin of ``repro.configs``).

``get_config(name)`` returns the published config from the module named
after the architecture.  All ten of the reference's configs are ported,
in its catalog's order: dense GQA decoders (yi-34b, mistral-nemo-12b,
internlm2-20b, qwen2-7b), the VLM backbone llama-3.2-vision-90b (gated
cross-attention over media embeddings), the SSM mamba2-370m, the
encoder-decoder whisper-base, the MoE models qwen3-moe-235b-a22b and
deepseek-v2-lite-16b (MLA, shared experts, a first dense layer) and the
hybrid jamba-v0.1-52b.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "get_config"]

ARCHS = [
    "yi-34b", "mistral-nemo-12b", "internlm2-20b", "qwen2-7b",
    "llama-3.2-vision-90b", "mamba2-370m", "whisper-base",
    "qwen3-moe-235b-a22b", "deepseek-v2-lite-16b", "jamba-v0.1-52b",
]


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown architecture {arch!r}; the catalog: {ARCHS}")
    mod = importlib.import_module("repro_torch.configs." + arch.replace("-", "_")
                                  .replace(".", "_"))
    return mod.CONFIG
