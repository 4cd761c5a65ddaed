"""mistral-nemo-12b — Mistral-Nemo-Base-2407 [hf:mistralai/Mistral-Nemo-Base-2407].

Dense GQA transformer, 128k-context class: 40 layers, d_model=5120, 32 heads
with explicit head_dim=128 (q proj 5120→4096), kv_heads=8, d_ff=14336,
vocab 131072 (Tekken tokenizer).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        mlp_kind="swiglu",
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-smoke",
        family="dense",
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        mlp_kind="swiglu",
        rope_theta=1_000_000.0,
    )
