"""qwen2-vl-7b — Qwen2-VL [arXiv:2409.12191] (language backbone).

VLM decoder with M-RoPE (3D t/h/w rotary sections 16/24/24 half-dims) and
dynamic-resolution vision input: 28 layers, d_model=3584, 28 heads GQA kv=4,
d_ff=18944, vocab 152064. The ViT frontend is not modelled: ``make_batch``
feeds precomputed patch embeddings (already projected to d_model) for the
first ``num_patch_positions`` positions.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        family="vlm",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        mlp_kind="swiglu",
        rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),  # head_dim 128 → half 64 = 16+24+24
        num_patch_positions=1024,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke",
        family="vlm",
        n_layers=2,
        d_model=128,
        n_heads=2,
        n_kv_heads=1,
        d_ff=256,
        vocab_size=512,
        mlp_kind="swiglu",
        mrope_sections=(8, 12, 12),  # head_dim 64 → half 32
        num_patch_positions=16,
    )
