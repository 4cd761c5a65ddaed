"""zamba2-1.2b — Zamba2 1.2B [arXiv:2411.15242].

Hybrid: 38 Mamba2 layers (d_model=2048, ssm_state=64) plus ONE weight-shared
attention+MLP block (32 heads MHA, d_ff=8192) applied after every 6 mamba
layers. The shared block runs sliding-window attention (w=4096) so the arch
stays sub-quadratic at long context.
"""
from repro_torch.models.config import Mamba2Config, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32000,
        mamba2=Mamba2Config(d_state=64, d_conv=4, expand=2, head_dim=64,
                            n_groups=1, chunk_size=256),
        shared_attn_every=6,
        sliding_window=4096,
        subquadratic=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke",
        family="hybrid",
        n_layers=4,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        mamba2=Mamba2Config(d_state=16, d_conv=4, expand=2, head_dim=32,
                            n_groups=1, chunk_size=16),
        shared_attn_every=2,
        sliding_window=32,
        subquadratic=True,
    )
