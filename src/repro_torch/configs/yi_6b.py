"""yi-6b — Yi: Open Foundation Models [arXiv:2403.04652].

Llama-architecture dense GQA: 32 layers, d_model=4096, 32 heads, kv_heads=4,
d_ff=11008, vocab 64000.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        d_ff=11008,
        vocab_size=64000,
        mlp_kind="swiglu",
        rope_theta=5_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-smoke",
        family="dense",
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=1,
        d_ff=512,
        vocab_size=512,
        mlp_kind="swiglu",
    )
