"""Attention: GQA, causal, optional sliding window; prefill and decode
(``repro.models.attention``'s counterpart, forward only).

  * ``naive_attention``       — materialises the (S, S) scores; the oracle.
  * ``flash_attention_plain`` — the blockwise online-softmax forward of
    the reference's ``_flash_fwd_impl``: the plain version of the
    hand-written kernel (``repro_torch.kernels.flash_attention``), which
    the kernel's wrapper runs for CPU tensors.
  * ``decode_attention``      — one query token against a ring-buffered
    KV cache (plain torch, as the reference computes it outside any
    kernel).

Layouts: q (B, S, H, D), k/v (B, S, KV, D|Dv) with H = KV * G.  The
backward (the reference's custom VJP) comes with the training slice.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _gqa_fold(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, S, H, D) → (B, KV, G, S, D)."""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d).permute(0, 2, 3, 1, 4)


def _gqa_unfold(o: torch.Tensor) -> torch.Tensor:
    """(B, KV, G, S, D) → (B, S, H, D)."""
    b, kv, g, s, d = o.shape
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, kv * g, d)


def _mask(rows: torch.Tensor, cols: torch.Tensor, causal: bool,
          window: int) -> torch.Tensor:
    """Valid (query row, key col) pairs; rows are in key positions."""
    mask = torch.ones(rows.shape[0], cols.shape[1], dtype=torch.bool,
                      device=rows.device)
    if causal:
        mask &= cols <= rows
    if window:
        mask &= cols > rows - window
    return mask


def naive_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None):
    """Reference attention; materialises full scores.  Test scale only."""
    sq, d = q.shape[1], q.shape[3]
    sk, n_kv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    qf = _gqa_fold(q, n_kv).float()
    kf = k.permute(0, 2, 1, 3).float()
    vf = v.permute(0, 2, 1, 3).float()
    scores = torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * scale
    rows = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    cols = torch.arange(sk, device=q.device)[None, :]
    scores = scores.masked_fill(~_mask(rows, cols, causal, window), NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", probs, vf)
    return _gqa_unfold(out).to(q.dtype)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: float | None = None, q_block: int = 512,
                          k_block: int = 512):
    """Blockwise online-softmax forward, the reference's ``_flash_fwd_impl``
    in f32 statistics, for any S (the last block of each axis is ragged).

    Key blocks that the causal mask or the window empties for a whole
    query block are skipped: the reference visits them, and they change
    nothing — before the first valid key the running max is NEG_INF and
    the first valid block rescales what was summed by exp(NEG_INF - m) =
    0; after it, they add exp(NEG_INF - m) = 0.  The hand-written kernel
    skips the same blocks."""
    b, sq, h, d = q.shape
    _, sk, n_kv, _ = k.shape
    dv = v.shape[-1]
    g = h // n_kv
    scale = scale if scale is not None else d ** -0.5
    q_off = sk - sq
    qf = _gqa_fold(q, n_kv)  # (B, KV, G, Sq, D)
    kf = k.permute(0, 2, 1, 3)  # (B, KV, Sk, D)
    vf = v.permute(0, 2, 1, 3)
    out = torch.empty((b, n_kv, g, sq, dv), dtype=torch.float32,
                      device=q.device)
    for q0 in range(0, sq, q_block):
        q1 = min(q0 + q_block, sq)
        qblk = qf[:, :, :, q0:q1].float() * scale
        rows = torch.arange(q0, q1, device=q.device)[:, None] + q_off
        k_lo = max(0, q0 + q_off - window + 1) if window else 0
        k_hi = min(sk, q1 + q_off) if causal else sk
        m = torch.full((b, n_kv, g, q1 - q0), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, n_kv, g, q1 - q0, dv), device=q.device)
        for k0 in range(k_lo - k_lo % k_block, k_hi, k_block):
            k1 = min(k0 + k_block, sk)
            s = torch.einsum("bkgqd,bksd->bkgqs", qblk,
                             kf[:, :, k0:k1].float())
            cols = torch.arange(k0, k1, device=q.device)[None, :]
            s = s.masked_fill(~_mask(rows, cols, causal, window), NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bksd->bkgqd", p, vf[:, :, k0:k1].float())
            m = m_new
        out[:, :, :, q0:q1] = acc / torch.clamp_min(l, 1e-30)[..., None]
    return _gqa_unfold(out).to(q.dtype)


def decode_attention(q, k_cache, v_cache, valid_mask, *, scale=None):
    """q: (B, 1, H, D); k/v_cache: (B, S, KV, D); valid_mask: (B, S) bool.

    Ring-buffered caches pass the validity mask of filled slots; the
    cached keys carry their RoPE, so slot order does not matter."""
    b, _, h, d = q.shape
    n_kv = k_cache.shape[2]
    scale = scale if scale is not None else d ** -0.5
    qf = _gqa_fold(q, n_kv)[..., 0, :].float()  # (B, KV, G, D)
    kf = k_cache.permute(0, 2, 1, 3).float()
    vf = v_cache.permute(0, 2, 1, 3).float()
    scores = torch.einsum("bkgd,bksd->bkgs", qf, kf) * scale
    scores = scores.masked_fill(~valid_mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", probs, vf)
    return out.reshape(b, 1, h, v_cache.shape[-1]).to(q.dtype)
