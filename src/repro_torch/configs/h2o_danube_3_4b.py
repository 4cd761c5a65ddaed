"""h2o-danube-3-4b — H2O-Danube3 [arXiv:2401.16818 lineage].

Llama+Mistral mix with sliding-window attention: 24 layers, d_model=3840,
32 heads (head_dim 120), kv_heads=8, d_ff=10240, vocab 32000, SWA w=4096.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b",
        family="dense",
        n_layers=24,
        d_model=3840,
        n_heads=32,
        n_kv_heads=8,
        d_ff=10240,
        vocab_size=32000,
        mlp_kind="swiglu",
        sliding_window=4096,
        rope_theta=10_000.0,
        subquadratic=True,  # SWA bounds both compute and KV cache
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="danube-smoke",
        family="dense",
        n_layers=2,
        d_model=240,  # keeps the family's non-128-aligned head_dim (60)
        n_heads=4,
        n_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        mlp_kind="swiglu",
        sliding_window=32,
        subquadratic=True,
    )
