"""DeepSeek-V2 Multi-head Latent Attention (``repro.models.mla``'s
counterpart).

Two forms, as in the reference:
  * prefill — "decompressed": the latent c_kv goes through kv_b into
    per-head K (nope) and V, and one call of the flash kernel attends
    with Dk = nope + rope (192 at deepseek-v2's widths) and Dv (128).
    K is the concatenation of k_nope and the shared rope key broadcast
    over the heads; V is the strided view ``kv[..., nope:]`` of the
    decompressed latents, which the kernel reads in place.
  * decode — "weight-absorbed": kv_b's key half folds into the query and
    its value half into the output, so one token attends straight
    against the cached latents (B, S, kv_lora) and rope keys (B, S,
    rope).  Plain float32 einsums, as the reference computes it outside
    any kernel.

The cache holds only (c_kv, k_pe): kv_lora + rope floats per token.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L
from repro_torch.models.attention import NEG_INF
from repro_torch.models.config import MLAConfig


def init_mla(gen: torch.Generator, d_model: int, n_heads: int,
             m: MLAConfig, dtype, device) -> dict:
    """The reference's tree: q_a, q_a_norm, q_b, kv_a, kv_a_norm, kv_b,
    o, each in its ``(d_in, d_out)`` layout."""
    dense = lambda shape: L.dense_init(gen, shape, dtype, device)
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "q_a": dense((d_model, m.q_lora_rank)),
        "q_a_norm": L.init_rmsnorm(m.q_lora_rank, dtype, device),
        "q_b": dense((m.q_lora_rank, n_heads * qk_head)),
        "kv_a": dense((d_model, m.kv_lora_rank + m.qk_rope_head_dim)),
        "kv_a_norm": L.init_rmsnorm(m.kv_lora_rank, dtype, device),
        "kv_b": dense((m.kv_lora_rank,
                       n_heads * (m.qk_nope_head_dim + m.v_head_dim))),
        "o": dense((n_heads * m.v_head_dim, d_model)),
    }


def mla_queries(params, x, cos, sin, n_heads: int, m: MLAConfig,
                eps: float):
    """x (B, S, D) → q_nope (B, S, H, nope), q_pe (B, S, H, rope), roped."""
    b, s, _ = x.shape
    cq = L.rmsnorm(params["q_a_norm"], x @ params["q_a"], eps)
    q = (cq @ params["q_b"]).reshape(
        b, s, n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_pe = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, L.apply_rope(q_pe, cos, sin)


def mla_latents(params, x, cos, sin, m: MLAConfig, eps: float):
    """x (B, S, D) → c_kv (B, S, kv_lora) normed, k_pe (B, S, rope)
    roped."""
    ckv_full = x @ params["kv_a"]
    c_kv = L.rmsnorm(params["kv_a_norm"], ckv_full[..., :m.kv_lora_rank],
                     eps)
    k_pe = L.apply_rope(ckv_full[:, :, None, m.kv_lora_rank:], cos, sin)
    return c_kv, k_pe[:, :, 0, :]


def mla_prefill(params, x, cos, sin, n_heads: int, m: MLAConfig,
                eps: float):
    """Full-sequence MLA.  Returns (attention out (B, S, D), c_kv, k_pe)
    for the cache."""
    b, s, _ = x.shape
    nope, rope = m.qk_nope_head_dim, m.qk_rope_head_dim
    q_nope, q_pe = mla_queries(params, x, cos, sin, n_heads, m, eps)
    c_kv, k_pe = mla_latents(params, x, cos, sin, m, eps)
    kv = (c_kv @ params["kv_b"]).reshape(b, s, n_heads, nope + m.v_head_dim)
    k = torch.cat([kv[..., :nope],
                   k_pe[:, :, None, :].expand(b, s, n_heads, rope)], dim=-1)
    o = flash_attention(torch.cat([q_nope, q_pe], dim=-1), k,
                        kv[..., nope:], causal=True,
                        scale=(nope + rope) ** -0.5)
    return o.reshape(b, s, n_heads * m.v_head_dim) @ params["o"], c_kv, k_pe


def mla_decode(params, x, cos, sin, c_kv_cache, k_pe_cache, valid_mask,
               n_heads: int, m: MLAConfig, eps: float):
    """Weight-absorbed single-token decode over caches that already hold
    the new token's latents.  x (B, 1, D); caches (B, S, kv_lora) and (B,
    S, rope); valid_mask (B, S) bool → attention out (B, 1, D)."""
    b = x.shape[0]
    nope = m.qk_nope_head_dim
    q_nope, q_pe = mla_queries(params, x, cos, sin, n_heads, m, eps)
    kv_b = params["kv_b"].reshape(m.kv_lora_rank, n_heads,
                                  nope + m.v_head_dim)
    q_lat = torch.einsum("bhn,lhn->bhl", q_nope[:, 0], kv_b[..., :nope])
    ckv = c_kv_cache.float()
    scores = (torch.einsum("bhl,bsl->bhs", q_lat.float(), ckv)
              + torch.einsum("bhr,bsr->bhs", q_pe[:, 0].float(),
                             k_pe_cache.float())
              ) * (nope + m.qk_rope_head_dim) ** -0.5
    scores = scores.masked_fill(~valid_mask[:, None, :], NEG_INF)
    out_lat = torch.einsum("bhs,bsl->bhl", torch.softmax(scores, dim=-1),
                           ckv)
    out = torch.einsum("bhl,lhv->bhv", out_lat.to(x.dtype), kv_b[..., nope:])
    return out.reshape(b, 1, n_heads * m.v_head_dim) @ params["o"]
