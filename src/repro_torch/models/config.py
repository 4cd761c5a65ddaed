"""Model configuration of the LM substrate (``repro.models.config``'s
counterpart).

One ``ModelConfig`` describes every architecture family of the zoo, so
that ``block_kinds`` and ``num_params`` agree with the reference for
every architecture; the port runs every block kind, M-RoPE and patch
embeddings, and not yet the codebooks of musicgen-medium.  The
reference's ``use_pallas`` switch and its three sharding specs have no
meaning here and are left out: the tensor's device picks the kernel
route, and the port runs on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (Mixtral / DeepSeek-V2 style)."""

    num_experts: int = 8
    num_experts_per_tok: int = 2
    expert_d_ff: int = 14336
    num_shared_experts: int = 0
    shared_d_ff: int = 0
    first_k_dense: int = 0
    router_aux_loss_coef: float = 0.01
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    """Mamba2 SSD settings (used by the zamba2 hybrid)."""

    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class RWKV6Config:
    """RWKV-v6 (Finch) settings."""

    head_dim: int = 64
    token_shift_rank: int = 32
    decay_rank: int = 64
    chunk_size: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config for the whole zoo (fields as in the reference)."""

    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0  # 0 → d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 32000
    mlp_kind: str = "swiglu"  # swiglu | squared_relu | gelu
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()
    sliding_window: int = 0  # 0 → full attention
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba2: Optional[Mamba2Config] = None
    rwkv6: Optional[RWKV6Config] = None
    shared_attn_every: int = 0
    num_codebooks: int = 0
    num_patch_positions: int = 0
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    subquadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def attn_out_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def param_torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def compute_torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def block_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind: "attn", "moe", "mla_dense"/"mla_moe",
        "mamba2" or "rwkv6" (zamba2's shared block is not listed)."""
        if self.rwkv6 is not None:
            return ("rwkv6",) * self.n_layers
        if self.mamba2 is not None:
            return ("mamba2",) * self.n_layers
        if self.mla is not None:
            if self.moe is None:
                raise ValueError("an MLA config here implies DeepSeek MoE")
            return tuple("mla_dense" if i < self.moe.first_k_dense
                         else "mla_moe" for i in range(self.n_layers))
        if self.moe is not None:
            return tuple("attn" if i < self.moe.first_k_dense else "moe"
                         for i in range(self.n_layers))
        return ("attn",) * self.n_layers

    def num_params(self) -> int:
        """Analytic parameter count, term for term the reference's."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        n_tables = max(1, self.num_codebooks)
        total = n_tables * v * d
        if not self.tie_embeddings:
            total += n_tables * d * v
        for kind in self.block_kinds():
            if kind in ("attn", "moe"):
                total += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                total += self.n_heads * hd * d + 2 * d
            if kind.startswith("mla"):
                m = self.mla
                total += d * m.q_lora_rank + m.q_lora_rank * self.n_heads * (
                    m.qk_nope_head_dim + m.qk_rope_head_dim)
                total += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                total += m.kv_lora_rank * self.n_heads * (
                    m.qk_nope_head_dim + m.v_head_dim)
                total += self.n_heads * m.v_head_dim * d
                total += 2 * d + m.q_lora_rank + m.kv_lora_rank
            if kind in ("attn", "mla_dense"):
                total += (3 if self.mlp_kind == "swiglu" else 2) * d * self.d_ff
            elif kind in ("moe", "mla_moe"):
                e = self.moe
                total += d * e.num_experts
                total += e.num_experts * 3 * d * e.expert_d_ff
                if e.num_shared_experts:
                    total += 3 * d * e.shared_d_ff
            elif kind == "mamba2":
                mc = self.mamba2
                di, nh = mc.d_inner(d), mc.n_heads(d)
                conv_dim = di + 2 * mc.n_groups * mc.d_state
                total += d * (2 * di + 2 * mc.n_groups * mc.d_state + nh)
                total += mc.d_conv * conv_dim + conv_dim
                total += 3 * nh + di + di * d + d
            elif kind == "rwkv6":
                r = self.rwkv6
                total += 4 * d * d + d * d
                total += d * 5 * r.token_shift_rank + 5 * r.token_shift_rank * d
                total += d * r.decay_rank + r.decay_rank * d
                total += 6 * d + 2 * d
                total += d * self.d_ff + self.d_ff * d + d * d
                total += 2 * d + 4 * d
        if self.shared_attn_every:
            total += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
            total += self.n_heads * hd * d + 3 * d * self.d_ff + 2 * d
        total += d  # final norm
        return total
