"""Llama-3.2-Vision-90B backbone [hf:meta-llama/Llama-3.2-11B-Vision,
scaled to the 90B widths].

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256; every 5th layer
is a gated cross-attention layer over 4100 precomputed patch embeddings
(the vision tower is not modelled: callers pass (batch, 4100, d_model)
media embeddings as ``batch["media"]``).
"""

from repro_torch.models.config import CrossAttnSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab_size=128256, head_dim=128, rope_theta=500_000.0,
    cross_attn=CrossAttnSpec(period=5, n_media_tokens=4100),
    microbatches=16,
    grad_accum_dtype="bfloat16",
)
