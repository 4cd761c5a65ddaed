"""musicgen-medium — MusicGen [arXiv:2306.05284] (decoder backbone).

Decoder-only LM over EnCodec tokens: 48 layers, d_model=1536, 24 heads (MHA),
d_ff=6144 (GELU, ungated), 4 codebooks of vocab 2048 with the delay
interleave pattern.  The EnCodec frontend is a stub, as in the reference:
the data pipeline supplies already-delayed codebook token streams
(B, 4, S); the model sums the 4 codebook embeddings and predicts 4 heads.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,
        mlp_kind="gelu",
        num_codebooks=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke",
        family="audio",
        n_layers=2,
        d_model=128,
        n_heads=2,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=128,
        mlp_kind="gelu",
        num_codebooks=4,
    )
