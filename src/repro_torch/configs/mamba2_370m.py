"""Mamba2-370M: attention-free SSD (state-space duality) [arXiv:2405.21060].

48L d_model=1024 (attn-free, no FFN: d_ff=0) vocab=50280, ssm_state=128.
d_inner = 2*1024 = 2048, head_dim 64 -> 32 SSD heads, 1 B/C group.
O(S) scan => runs the long_500k shape.
"""

from repro_torch.models.config import ModelConfig, SSMSpec

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=32, n_kv_heads=32, d_ff=0,
    vocab_size=50280, pos_embed="none", tie_embeddings=True,
    ssm=SSMSpec(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                chunk=256),
    sub_quadratic=True,
)
