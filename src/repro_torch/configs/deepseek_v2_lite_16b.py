"""DeepSeek-V2-Lite-16B: MLA + MoE [arXiv:2405.04434].

27L d_model=2048 16H MLA (kv_lora=512, qk_nope=128, qk_rope=64, v=128)
vocab=102400; layer 0 uses a dense 10944-wide FFN, layers 1-26 are MoE
with 64 routed experts (top-6) + 2 shared experts of d_ff=1408.

The Lite model has 64 routed experts and 2 shared ones (full
DeepSeek-V2 has 160 routed).  MLA's value head (128) differs from its
query/key head (192), which no attention kernel takes: MLA attends on the
plain path in both packages (``models/attention.py``).
"""

from repro_torch.models.config import MLASpec, ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=10944,
    vocab_size=102400, rope_theta=10_000.0,
    mla=MLASpec(kv_lora_rank=512, q_lora_rank=0, qk_nope_dim=128,
                qk_rope_dim=64, v_head_dim=128),
    moe=MoESpec(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                d_ff_shared=2816),
    first_k_dense=1,
)
