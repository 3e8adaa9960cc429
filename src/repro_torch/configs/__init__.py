"""Architecture registry (twin of ``repro.configs``).

``get_config(name)`` returns the published config from the module named
after the architecture.  All ten of the reference's configs are ported,
in its catalog's order: dense GQA decoders (yi-34b, mistral-nemo-12b,
internlm2-20b, qwen2-7b), the VLM backbone llama-3.2-vision-90b (gated
cross-attention over media embeddings), the SSM mamba2-370m, the
encoder-decoder whisper-base, the MoE models qwen3-moe-235b-a22b and
deepseek-v2-lite-16b (MLA, shared experts, a first dense layer) and the
hybrid jamba-v0.1-52b.

``SHAPES`` holds the four input cells every (arch x shape) pair of the
dry-run and roofline is cut from; ``applicable`` gives a pair's skip
reason and ``all_cells`` the runnable pairs and the skips, as in the
reference.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "SHAPES", "get_config", "applicable", "ShapeSpec",
           "all_cells"]

ARCHS = [
    "yi-34b", "mistral-nemo-12b", "internlm2-20b", "qwen2-7b",
    "llama-3.2-vision-90b", "mamba2-370m", "whisper-base",
    "qwen3-moe-235b-a22b", "deepseek-v2-lite-16b", "jamba-v0.1-52b",
]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown architecture {arch!r}; the catalog: {ARCHS}")
    mod = importlib.import_module("repro_torch.configs." + arch.replace("-", "_")
                                  .replace(".", "_"))
    return mod.CONFIG


def applicable(arch: str, shape: str) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the documented skip reason."""
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.sub_quadratic:
        return ("full quadratic attention: 524288-token decode is "
                "intentionally skipped (DESIGN.md §Arch-applicability); "
                "run for SSM/hybrid archs only")
    return None


def all_cells():
    """Every runnable (arch, shape) pair plus the documented skips."""
    run, skip = [], []
    for a in ARCHS:
        for s in SHAPES:
            reason = applicable(a, s)
            (skip if reason else run).append((a, s, reason))
    return run, skip
