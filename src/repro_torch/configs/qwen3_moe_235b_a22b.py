"""Qwen3-235B-A22B: MoE decoder [hf:Qwen/Qwen3-30B-A3B family, per
assignment].

94L d_model=4096 64H (GQA kv=4, head_dim=128) vocab=151936;
MoE: 128 experts, top-8, d_ff=1536 per expert, no shared experts,
renormalised top-k gates.
"""

from repro_torch.models.config import ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_ff=0,
    vocab_size=151936, head_dim=128, rope_theta=1_000_000.0,
    moe=MoESpec(n_experts=128, top_k=8, d_ff_expert=1536),
    microbatches=8,
    grad_accum_dtype="bfloat16",
)
