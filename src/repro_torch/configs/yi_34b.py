"""Yi-34B: llama-arch dense GQA decoder [arXiv:2403.04652].

60L d_model=7168 56H (GQA kv=8, head_dim=128) d_ff=20480 vocab=64000.
56 heads do not divide the 16-way model axis -> attention runs
sequence-TP (see attention.py); FFN/vocab shard cleanly.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480,
    vocab_size=64000, head_dim=128, rope_theta=5_000_000.0,
    microbatches=2,
)
