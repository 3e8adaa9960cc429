"""Architecture configuration dataclasses (twin of ``repro.models.config``).

The fields, their defaults and ``reduced()`` are the reference's, field
for field, so a config round-trips between the two packages (the CPU
tests pin this).  The one difference is the kernel flag:
``use_kernels`` replaces the reference's ``use_pallas`` /
``pallas_device`` pair and defaults to True.  With it set, attention and
the MoE expert products run the hand-written CUDA kernels on CUDA
tensors and their plain PyTorch versions on CPU tensors;
``use_kernels=False`` asks for the reference's plain path instead.

Fields the serving path does not read (the training knobs: remat,
scan_layers, microbatches, grad_accum_dtype) are kept so the training
slice ports against an unchanged config.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ModelConfig", "MoESpec", "MLASpec", "SSMSpec", "CrossAttnSpec",
           "EncoderSpec"]


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # always-on shared experts (deepseek)
    d_ff_shared: int = 0
    period: int = 1              # MoE every `period` layers (jamba: 2)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001


@dataclasses.dataclass(frozen=True)
class MLASpec:
    """Multi-head Latent Attention (DeepSeek-V2)."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0         # 0 => no query compression (V2-Lite)
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    """Mamba2 / SSD (state-space duality) mixer."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class CrossAttnSpec:
    """VLM: every `period`-th layer cross-attends to media embeddings."""
    period: int = 5
    n_media_tokens: int = 4100


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    """Whisper-style encoder over precomputed frame embeddings."""
    n_layers: int = 6
    n_frames: int = 1500


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | vlm | ssm | audio | moe | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 => d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    norm_type: str = "rms"       # rms | layer
    mlp_type: str = "swiglu"     # swiglu | gelu
    pos_embed: str = "rope"      # rope | learned | none
    tie_embeddings: bool = False
    moe: Optional[MoESpec] = None
    mla: Optional[MLASpec] = None
    ssm: Optional[SSMSpec] = None
    cross_attn: Optional[CrossAttnSpec] = None
    encoder: Optional[EncoderSpec] = None
    # hybrid (jamba): one attention layer per `attn_period` layers at
    # `attn_offset` within the period; all other mixers are SSM.
    attn_period: int = 0
    attn_offset: int = 0
    first_k_dense: int = 0       # deepseek: first k layers use dense FFN
    dtype: str = "bfloat16"
    sub_quadratic: bool = False  # can lower long_500k (SSM/hybrid)
    remat: str = "full"          # full | dots | none  (activation ckpt policy)
    scan_layers: bool = True
    microbatches: int = 1        # train-step gradient-accumulation factor
    # run the hand-written Hopper kernels (their plain PyTorch versions
    # on CPU tensors); False selects the reference's plain path
    use_kernels: bool = True
    grad_accum_dtype: str = "float32"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_attn_free(self) -> bool:
        return self.family == "ssm"

    def layer_kind(self, idx: int) -> str:
        """'attn' or 'ssm' mixer for global layer index `idx` (hybrid)."""
        if self.family == "ssm":
            return "ssm"
        if self.attn_period:
            return "attn" if idx % self.attn_period == self.attn_offset else "ssm"
        return "attn"

    def layer_is_moe(self, idx: int) -> bool:
        if self.moe is None or idx < self.first_k_dense:
            return False
        return (idx - self.first_k_dense) % self.moe.period == 0 \
            if self.moe.period > 1 else idx >= self.first_k_dense

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family/wiring, tiny dims."""
        kw = dict(
            microbatches=1,
            n_layers=max(2, min(4, self.n_layers)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
        )
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=2, d_ff_expert=64,
                d_ff_shared=64 if self.moe.n_shared else 0)
        if self.mla:
            kw["mla"] = MLASpec(kv_lora_rank=32, q_lora_rank=0,
                                qk_nope_dim=16, qk_rope_dim=16, v_head_dim=16)
            kw["head_dim"] = 0
        if self.ssm:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=16, head_dim=16,
                                            chunk=32)
        if self.cross_attn:
            kw["cross_attn"] = dataclasses.replace(self.cross_attn, period=2,
                                                   n_media_tokens=16)
            kw["n_layers"] = 4
        if self.encoder:
            kw["encoder"] = EncoderSpec(n_layers=2, n_frames=32)
        if self.attn_period:
            kw["attn_period"] = min(self.attn_period, 4)
            kw["attn_offset"] = min(self.attn_offset, 3)
            kw["n_layers"] = 2 * min(self.attn_period, 4)
        if self.first_k_dense:
            kw["first_k_dense"] = 1
        return dataclasses.replace(self, name=self.name + "-smoke", **kw)
