"""mixtral-8x7b — Mixtral of Experts [arXiv:2401.04088].

Sparse MoE: 32 layers, d_model=4096, 32 heads GQA kv=8, 8 experts top-2
(expert d_ff=14336), sliding-window attention w=4096, vocab 32000.
"""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        moe=MoEConfig(num_experts=8, num_experts_per_tok=2,
                      expert_d_ff=14336),
        sliding_window=4096,
        rope_theta=1_000_000.0,
        subquadratic=True,  # SWA bounds both compute and KV cache
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke",
        family="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        moe=MoEConfig(num_experts=4, num_experts_per_tok=2, expert_d_ff=256),
        sliding_window=32,
        subquadratic=True,
    )
