"""Jamba-v0.1-52B: hybrid Mamba+attention 1:7 interleave with MoE
[arXiv:2403.19887].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536; one attention
layer per 8 (offset 4), MoE (16 experts, top-2, d_ff=14336) every other
layer; Mamba mixers d_state=16, conv=4, expand=2.  No explicit positional
embedding (the SSM provides position).  Sub-quadratic overall -> runs
long_500k (the 4 attention layers use the blockwise kernel; mamba is O(S)).
"""

from repro_torch.models.config import ModelConfig, MoESpec, SSMSpec

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=65536, head_dim=128, pos_embed="none",
    attn_period=8, attn_offset=4,
    moe=MoESpec(n_experts=16, top_k=2, d_ff_expert=14336, period=2),
    ssm=SSMSpec(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1,
                chunk=256),
    sub_quadratic=True,
    microbatches=8,
)
