"""rwkv6-1.6b — RWKV-v6 "Finch" 1.6B [arXiv:2404.05892].

Attention-free SSM-family LM with data-dependent decay: 24 layers,
d_model=2048, d_ff=7168 (channel-mix), vocab 65536, head_dim 64.
"""
from repro_torch.models.config import ModelConfig, RWKV6Config


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        family="ssm",
        n_layers=24,
        d_model=2048,
        n_heads=32,           # 2048 / 64 wkv heads
        n_kv_heads=32,
        d_ff=7168,
        vocab_size=65536,
        rwkv6=RWKV6Config(head_dim=64, chunk_size=64),
        subquadratic=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke",
        family="ssm",
        n_layers=2,
        d_model=128,
        n_heads=2,
        n_kv_heads=2,
        d_ff=448,
        vocab_size=512,
        rwkv6=RWKV6Config(head_dim=64, chunk_size=16),
        subquadratic=True,
    )
