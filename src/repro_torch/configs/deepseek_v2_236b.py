"""deepseek-v2-236b — DeepSeek-V2 [arXiv:2405.04434].

MLA + fine-grained MoE: 60 layers, d_model=5120, 128 heads with Multi-head
Latent Attention (q_lora=1536, kv_lora=512, qk nope/rope 128/64, v=128),
first layer dense (d_ff=12288), remaining 59 layers MoE with 2 shared +
160 routed experts top-6 (expert d_ff=1536), vocab 102400.
"""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        d_ff=12288,  # the single dense layer
        vocab_size=102400,
        mlp_kind="swiglu",
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(num_experts=160, num_experts_per_tok=6,
                      expert_d_ff=1536, num_shared_experts=2,
                      shared_d_ff=3072, first_k_dense=1,
                      capacity_factor=1.25),
        rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-smoke",
        family="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        mlp_kind="swiglu",
        mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                      qk_nope_head_dim=32, qk_rope_head_dim=16,
                      v_head_dim=32),
        moe=MoEConfig(num_experts=4, num_experts_per_tok=2,
                      expert_d_ff=128, num_shared_experts=1,
                      shared_d_ff=128, first_k_dense=1),
    )
