"""Attention: GQA, causal, optional sliding window; prefill, decode and
the flash backward (``repro.models.attention``'s counterpart).

  * ``naive_attention``       — materialises the (S, S) scores; the oracle.
  * ``flash_attention_plain`` — the blockwise online-softmax forward of
    the reference's ``_flash_fwd_impl`` (and, on request, its LSE): the
    plain version of the hand-written kernel
    (``repro_torch.kernels.flash_attention``), which the kernel's wrapper
    runs for CPU tensors.
  * ``flash_attention_backward_plain`` — the reference's blockwise
    ``_flash_vjp_bwd``: the plain version of the backward kernel.
  * ``decode_attention``      — one query token against a ring-buffered
    KV cache (plain torch, as the reference computes it outside any
    kernel).

Layouts: q (B, S, H, D), k/v (B, S, KV, D|Dv) with H = KV * G; the LSE
is (B, H, Sq) float32.
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


def _key_blocks(q0: int, q1: int, q_off: int, sk: int, causal: bool,
                window: int, k_block: int) -> range:
    """Starts of the key blocks a query block [q0, q1) can see."""
    k_lo = max(0, q0 + q_off - window + 1) if window else 0
    k_hi = min(sk, q1 + q_off) if causal else sk
    return range(k_lo - k_lo % k_block, k_hi, k_block)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: float | None = None, q_block: int = 512,
                          k_block: int = 512, return_lse: bool = False):
    """Blockwise online-softmax forward, the reference's ``_flash_fwd_impl``
    in f32 statistics, for any S (the last block of each axis is ragged).
    Returns o, or (o, lse (B, H, Sq) float32) with ``return_lse``.

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
    lse = torch.empty((b, n_kv, g, sq), dtype=torch.float32,
                      device=q.device)
    for q0 in range(0, sq, q_block):
        q1 = min(q0 + q_block, sq)
        qblk = qf[:, :, :, q0:q1].float() * scale
        rows = torch.arange(q0, q1, device=q.device)[:, None] + q_off
        m = torch.full((b, n_kv, g, q1 - q0), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, n_kv, g, q1 - q0, dv), device=q.device)
        for k0 in _key_blocks(q0, q1, q_off, sk, causal, window, k_block):
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
        lse[:, :, :, q0:q1] = m + torch.log(torch.clamp_min(l, 1e-30))
    o = _gqa_unfold(out).to(q.dtype)
    return (o, lse.reshape(b, n_kv * g, sq)) if return_lse else o


def flash_attention_backward_plain(q, k, v, o, lse, do, *,
                                   causal: bool = True, window: int = 0,
                                   scale: float | None = None,
                                   q_block: int = 512, k_block: int = 512):
    """The reference's blockwise flash backward (``_flash_vjp_bwd``): p
    recomputed per block pair from the LSE, in float32,

        p = exp(s - lse),  dp = do · vᵀ,  ds = p ⊙ (dp − δ) · scale,
        dq = Σ ds k,  dk = Σ dsᵀ q,  dv = Σ pᵀ do,  δ = rowsum(do ⊙ o),

    dk and dv summed over each kv head's G query heads.  Key blocks a
    query block cannot see are skipped (they add exact zeros).  Returns
    (dq, dk, dv) in q's, k's and v's dtypes."""
    b, sq, h, d = q.shape
    _, sk, n_kv, _ = k.shape
    dv_dim = v.shape[-1]
    g = h // n_kv
    scale = scale if scale is not None else d ** -0.5
    q_off = sk - sq
    qf = _gqa_fold(q, n_kv).float()   # (B, KV, G, Sq, D)
    dof = _gqa_fold(do, n_kv).float()  # (B, KV, G, Sq, Dv)
    kf = k.permute(0, 2, 1, 3).float()  # (B, KV, Sk, D)
    vf = v.permute(0, 2, 1, 3).float()
    delta = (dof * _gqa_fold(o, n_kv).float()).sum(-1)  # (B, KV, G, Sq)
    lsef = lse.reshape(b, n_kv, g, sq).float()
    dq = torch.zeros((b, n_kv, g, sq, d), device=q.device)
    dk = torch.zeros((b, n_kv, sk, d), device=q.device)
    dv = torch.zeros((b, n_kv, sk, dv_dim), device=q.device)
    for q0 in range(0, sq, q_block):
        q1 = min(q0 + q_block, sq)
        qblk, doblk = qf[:, :, :, q0:q1], dof[:, :, :, q0:q1]
        lblk, dblk = lsef[..., q0:q1, None], delta[..., q0:q1, None]
        rows = torch.arange(q0, q1, device=q.device)[:, None] + q_off
        for k0 in _key_blocks(q0, q1, q_off, sk, causal, window, k_block):
            k1 = min(k0 + k_block, sk)
            kblk, vblk = kf[:, :, k0:k1], vf[:, :, k0:k1]
            s = torch.einsum("bkgqd,bksd->bkgqs", qblk, kblk) * scale
            cols = torch.arange(k0, k1, device=q.device)[None, :]
            s = s.masked_fill(~_mask(rows, cols, causal, window), NEG_INF)
            p = torch.exp(s - lblk)
            dp = torch.einsum("bkgqe,bkse->bkgqs", doblk, vblk)
            ds = p * (dp - dblk) * scale
            dq[:, :, :, q0:q1] += torch.einsum("bkgqs,bksd->bkgqd", ds, kblk)
            dk[:, :, k0:k1] += torch.einsum("bkgqs,bkgqd->bksd", ds, qblk)
            dv[:, :, k0:k1] += torch.einsum("bkgqs,bkgqe->bkse", p, doblk)
    return (_gqa_unfold(dq).to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


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
