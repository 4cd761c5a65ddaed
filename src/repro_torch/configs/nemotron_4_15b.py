"""nemotron-4-15b — Nemotron-4 15B [arXiv:2402.16819].

Dense GQA transformer with squared-ReLU MLP (no gating): 32 layers,
d_model=6144, 48 heads, kv_heads=8, d_ff=24576, vocab 256000.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b",
        family="dense",
        n_layers=32,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=24576,
        vocab_size=256000,
        mlp_kind="squared_relu",
        rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-smoke",
        family="dense",
        n_layers=2,
        d_model=192,
        n_heads=3,
        n_kv_heads=1,
        d_ff=768,
        vocab_size=512,
        mlp_kind="squared_relu",
    )
