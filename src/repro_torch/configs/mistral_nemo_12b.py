"""Mistral-Nemo-12B (Base-2407): dense GQA, 128k context
[hf:mistralai/Mistral-Nemo-Base-2407].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072; head_dim=128
(explicit in the HF config: 32*128 = 4096 != d_model).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=131072, head_dim=128, rope_theta=1_000_000.0,
    microbatches=2,
)
