"""Mamba2 (SSD) mixer: chunked scan for prefill, recurrent decode
(``repro.models.mamba2``'s counterpart).

  * ``ssd_chunked``    — the chunked SSD scan (masked quadratic form in
    each chunk, a short loop carrying the (H, P, N) state across
    chunks): with the D skip term it is the plain version of the
    hand-written kernel (``repro_torch.kernels.ssd.ssd_plain``).
  * ``mamba2_forward`` — the full mixer over a sequence.  Its scan goes
    through the kernel wrapper ``repro_torch.kernels.ssd.ssd``, whose
    route the tensors' device picks, with the D skip term folded into
    the call as ``ssd_pallas`` does (the reference adds it afterwards:
    the same arithmetic).
  * ``mamba2_decode``  — one token against the (conv tail, SSM state)
    cache, plain torch as the reference computes it outside any kernel;
    the cache is updated **in place**.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import ssd
from repro_torch.models.config import Mamba2Config
from repro_torch.models.layers import (dense_init, gated_rmsnorm,
                                       init_gated_rmsnorm)


def init_mamba2(gen, d_model: int, mc: Mamba2Config, dtype, device) -> dict:
    d_in = mc.d_inner(d_model)
    nh = mc.n_heads(d_model)
    conv_dim = d_in + 2 * mc.n_groups * mc.d_state
    proj_out = 2 * d_in + 2 * mc.n_groups * mc.d_state + nh
    f32 = torch.float32
    return {
        "in_proj": dense_init(gen, (d_model, proj_out), dtype, device),
        "conv_w": dense_init(gen, (mc.d_conv, conv_dim), dtype, device,
                             scale=0.5),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        # S4D-style A init: A in [-1, -nh] roughly; store log(-A)
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32,
                                          device=device)),
        "D": torch.ones((nh,), dtype=f32, device=device),
        "dt_bias": torch.zeros((nh,), dtype=f32, device=device),
        "norm": init_gated_rmsnorm(d_in, dtype, device),
        "out_proj": dense_init(gen, (d_in, d_model), dtype, device),
    }


def _split_proj(zxbcdt, d_in: int, mc: Mamba2Config):
    gn = mc.n_groups * mc.d_state
    z = zxbcdt[..., :d_in]
    xs = zxbcdt[..., d_in:2 * d_in]
    bb = zxbcdt[..., 2 * d_in:2 * d_in + gn]
    cc = zxbcdt[..., 2 * d_in + gn:2 * d_in + 2 * gn]
    dt = zxbcdt[..., 2 * d_in + 2 * gn:]
    return z, xs, bb, cc, dt


def _causal_conv(x, w, b):
    """x: (B, S, C); w: (K, C) depthwise causal conv; b: (C,)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return out + b


def _segsum(t):
    """t: (..., Q) → (..., Q, Q) lower-triangular pairwise sums.

    out[.., i, j] = sum_{j < k <= i} t[.., k]  (i >= j), -inf above diag.
    """
    q = t.shape[-1]
    cs = torch.cumsum(t, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=t.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(xs, dt, A, B, C, chunk: int, init_state=None):
    """Chunked SSD scan in float32, or float64 for float64 inputs (the
    reference's takes its chunk from a ``Mamba2Config``; here it is
    ``chunk``).

    xs: (B, S, H, P); dt: (B, S, H) (post-softplus); A: (H,) negative;
    B, C: (B, S, G, N).  Returns (y (B,S,H,P) in xs's dtype, final state
    (B,H,P,N) in the compute dtype)."""
    b, s, h, p = xs.shape
    g, n = B.shape[2], B.shape[3]
    q = min(chunk, s)
    if s % q:  # end-pad to a chunk multiple: x=0, dt=0 is exact
        pad = q - s % q
        p4 = lambda a: F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
        y, fin = ssd_chunked(p4(xs), p4(dt), A, p4(B), p4(C), chunk,
                             init_state)
        return y[:, :s], fin
    nc = s // q
    hg = h // g  # heads per group

    ft = torch.float64 if xs.dtype == torch.float64 else torch.float32
    xs_c = xs.to(ft).reshape(b, nc, q, h, p)
    dt_c = dt.to(ft).reshape(b, nc, q, h)
    B_c = B.to(ft).reshape(b, nc, q, g, n)
    C_c = C.to(ft).reshape(b, nc, q, g, n)
    dA = dt_c * A.to(ft)  # (b, nc, q, h) — negative

    # intra-chunk (diagonal blocks): masked quadratic form
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))  # (b, nc, h, q, q)
    cb = torch.einsum("bcqgn,bcsgn->bcgqs", C_c, B_c)
    cb = cb.repeat_interleave(hg, dim=2)  # (b, nc, h, q, q)
    scores = cb * L * dt_c.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_diag = torch.einsum("bchqs,bcshp->bcqhp", scores, xs_c)

    # chunk states: decay-weighted sum of outer products
    dA_cum = torch.cumsum(dA, dim=2)  # (b, nc, q, h)
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)
    xw = xs_c * (dt_c * decay_to_end)[..., None]
    B_h = B_c.repeat_interleave(hg, dim=3)  # (b, nc, q, h, n)
    states = torch.einsum("bcqhp,bcqhn->bchpn", xw, B_h)

    # inter-chunk recurrence: the state at each chunk's start
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])  # (b, nc, h)
    state = (torch.zeros((b, h, p, n), dtype=ft, device=xs.device)
             if init_state is None else init_state.to(ft))
    starts = []
    for ci in range(nc):
        starts.append(state)
        state = state * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(starts, dim=1)  # (b, nc, h, p, n)

    # contribution of the carried-in state to each position
    decay_from_start = torch.exp(dA_cum)  # (b, nc, q, h)
    C_h = C_c.repeat_interleave(hg, dim=3)  # (b, nc, q, h, n)
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", C_h, prev_states,
                         decay_from_start)
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y.to(xs.dtype), state


def mamba2_forward(params, x, mc: Mamba2Config, eps: float,
                   init_state=None):
    """Full mamba2 mixer.  x: (B, S, D) → (y, (conv_tail, ssm_state))."""
    b, s, d = x.shape
    d_in = mc.d_inner(d)
    nh = mc.n_heads(d)
    gn = mc.n_groups * mc.d_state
    zxbcdt = x @ params["in_proj"]
    z, _, _, _, dt = _split_proj(zxbcdt, d_in, mc)
    xbc = zxbcdt[..., d_in:2 * d_in + 2 * gn]  # [xs, B, C]: a view
    if init_state is not None:
        conv_tail_in = init_state[0]  # (B, d_conv-1, conv_dim)
        xbc_ext = torch.cat([conv_tail_in, xbc], dim=1)
        conv = _causal_conv(xbc_ext, params["conv_w"], params["conv_b"])
        conv = conv[:, -s:]
    else:
        conv = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    conv = F.silu(conv)
    # x, B and C stay strided views of conv: the kernel reads strides
    xs_c = conv[..., :d_in].reshape(b, s, nh, mc.head_dim)
    B_ = conv[..., d_in:d_in + gn].reshape(b, s, mc.n_groups, mc.d_state)
    C_ = conv[..., d_in + gn:].reshape(b, s, mc.n_groups, mc.d_state)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])  # (H,) negative
    y, ssm_state = ssd(
        xs_c, dt.to(xs_c.dtype), A, B_, C_, params["D"],
        chunk=mc.chunk_size,
        init_state=(None if init_state is None
                    else init_state[1].float().contiguous()))
    y = y.reshape(b, s, d_in)
    y = gated_rmsnorm(params["norm"], y, z, eps)
    out = y @ params["out_proj"]
    k = mc.d_conv - 1
    conv_tail = torch.cat(
        [xbc.new_zeros((b, k, xbc.shape[-1])), xbc[:, -k:]], dim=1)[:, -k:]
    return out, (conv_tail, ssm_state.to(x.dtype))


def mamba2_decode(params, x, state, mc: Mamba2Config, eps: float):
    """Single-token recurrent step.

    x: (B, 1, D); state = (conv_tail (B, d_conv-1, conv_dim),
    ssm_state (B, H, P, N)), both updated in place.  Returns
    (y (B,1,D), state)."""
    b, _, d = x.shape
    d_in = mc.d_inner(d)
    nh = mc.n_heads(d)
    gn = mc.n_groups * mc.d_state
    conv_tail, ssm_state = state
    zxbcdt = x[:, 0] @ params["in_proj"]  # (B, proj)
    z, _, _, _, dt = _split_proj(zxbcdt, d_in, mc)
    xbc = zxbcdt[:, d_in:2 * d_in + 2 * gn]  # (B, conv_dim)
    window = torch.cat([conv_tail, xbc[:, None]], dim=1)  # (B, K, C)
    conv = (torch.einsum("bkc,kc->bc", window, params["conv_w"])
            + params["conv_b"])
    conv = F.silu(conv)
    xs_t = conv[:, :d_in].reshape(b, nh, mc.head_dim)
    B_ = conv[:, d_in:d_in + gn].reshape(b, mc.n_groups, mc.d_state)
    C_ = conv[:, d_in + gn:].reshape(b, mc.n_groups, mc.d_state)
    hg = nh // mc.n_groups
    B_h = B_.repeat_interleave(hg, dim=1)  # (B, H, N)
    C_h = C_.repeat_interleave(hg, dim=1)
    dt = F.softplus(dt.float() + params["dt_bias"])  # (B, H)
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt * A).to(xs_t.dtype)  # (B, H)
    upd = torch.einsum("bhp,bhn->bhpn",
                       xs_t * dt.to(xs_t.dtype)[..., None], B_h)
    ssm_state.mul_(decay[..., None, None]).add_(upd)
    y = torch.einsum("bhpn,bhn->bhp", ssm_state, C_h)
    y = y + xs_t * params["D"].to(y.dtype)[None, :, None]
    y = y.reshape(b, d_in)
    y = gated_rmsnorm(params["norm"], y, z, eps)
    out = (y @ params["out_proj"])[:, None]
    conv_tail.copy_(window[:, 1:])
    return out, (conv_tail, ssm_state)
