"""Whisper-base: encoder-decoder audio model [arXiv:2212.04356].

6L enc + 6L dec, d_model=512 8H (kv=8) d_ff=2048 vocab=51865; LayerNorm,
GELU MLP, learned positions, tied embeddings.  The conv audio frontend is
not modelled: the encoder consumes precomputed (batch, 1500, 512) frame
embeddings, ``batch["frames"]``.
"""

from repro_torch.models.config import EncoderSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
    vocab_size=51865, norm_type="layer", mlp_type="gelu",
    pos_embed="learned", tie_embeddings=True,
    encoder=EncoderSpec(n_layers=6, n_frames=1500),
)
