"""RWKV-v6 (Finch): data-dependent-decay linear attention
(``repro.models.rwkv6``'s counterpart).

Forms of the WKV core (per head, state S of N x N, N = head_dim):
    o_t[j] = sum_i r_t[i] (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
    S_t    = diag(exp(lw_t)) S_{t-1} + k_t v_t^T,   lw_t <= 0
  * ``wkv6_recurrent`` — the exact per-step recurrence; the oracle and
    the decode path.
  * ``wkv6_chunked``   — the chunked parallel form with tile-referenced
    exponents (every ``exp`` argument <= 0): the plain version of the
    hand-written kernel (``repro_torch.kernels.wkv6``).

Prefill (``rwkv6_time_mix`` without a state) goes through the kernel
wrapper, whose route the tensors' device picks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.wkv6 import wkv6
from repro_torch.models.config import RWKV6Config
from repro_torch.models.layers import dense_init


# ---------------------------------------------------------------------------
# WKV core
# ---------------------------------------------------------------------------

def wkv6_recurrent(r, k, v, lw, u, init_state=None):
    """Exact scan.  r, k, v, lw: (B, S, H, N); u: (H, N).

    Returns (o (B, S, H, N) in r's dtype, final state (B, H, N, N) f32)."""
    b, s, h, n = r.shape
    state = (torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
             if init_state is None else init_state.float())
    rf, kf, vf, lwf = (a.float() for a in (r, k, v, lw))
    uf = u.float()
    outs = []
    for t in range(s):
        rt, kt, vt = rf[:, t], kf[:, t], vf[:, t]  # (B, H, N)
        bonus = uf[None] * kt
        o = (torch.einsum("bhi,bhij->bhj", rt, state)
             + torch.einsum("bhi,bhi,bhj->bhj", rt, bonus, vt))
        state = (state * torch.exp(lwf[:, t])[..., None]
                 + torch.einsum("bhi,bhj->bhij", kt, vt))
        outs.append(o)
    o = (torch.stack(outs, dim=1) if outs
         else torch.zeros_like(rf))
    return o.to(r.dtype), state


def wkv6_chunked(r, k, v, lw, u, init_state=None, *, chunk: int = 64,
                 tile: int = 32):
    """Chunked parallel WKV; same signature and semantics as
    ``wkv6_recurrent``.  S is end-padded to a chunk multiple (zero
    r/k/v and zero log-decay contribute nothing).  Computes in float32,
    or in float64 when r is float64 (a yardstick for the kernel at long
    S, where the float32 form's own rounding nears the kernel's bar)."""
    b, s, h, n = r.shape
    q = min(chunk, s)
    if s % q:
        pad = q - s % q
        pz = lambda a: F.pad(a, (0, 0, 0, 0, 0, pad))
        o, fin = wkv6_chunked(pz(r), pz(k), pz(v), pz(lw), u, init_state,
                              chunk=chunk, tile=tile)
        return o[:, :s], fin
    nc = s // q
    tau = min(tile, q)
    if q % tau:
        raise ValueError(f"chunk {q} must be a multiple of tile {tau}")
    ft = torch.float64 if r.dtype == torch.float64 else torch.float32
    dev = r.device

    rc, kc, vc, lwc = (a.to(ft).reshape(b, nc, q, h, n)
                       for a in (r, k, v, lw))
    cw = torch.cumsum(lwc, dim=2)  # inclusive within the chunk
    ecw = cw - lwc  # exclusive
    uf = u.to(ft)
    state = (torch.zeros((b, h, n, n), dtype=ft, device=dev)
             if init_state is None else init_state.to(ft))
    strictly_lower = torch.tril(torch.ones((tau, tau), dtype=torch.bool,
                                           device=dev), diagonal=-1)
    eye = torch.eye(tau, dtype=ft, device=dev)

    ys = []
    for c in range(nc):
        rq, kq, vq, cwq, ecwq = (a[:, c] for a in (rc, kc, vc, cw, ecw))
        # cross-chunk: o_t += (r_t * exp(ecw_t)) @ S_prev
        y = torch.einsum("bqhi,bhij->bqhj", rq * torch.exp(ecwq), state)
        for t0 in range(0, q, tau):
            ref = ecwq[:, t0]  # (b, h, n): tile-start reference
            if t0 > 0:  # keys strictly before the tile, exponents <= 0
                q_t = rq[:, t0:t0 + tau] * torch.exp(
                    ecwq[:, t0:t0 + tau] - ref[:, None])
                k_s = kq[:, :t0] * torch.exp(ref[:, None] - cwq[:, :t0])
                a_off = torch.einsum("bthn,bshn->bhts", q_t, k_s)
                y[:, t0:t0 + tau] += torch.einsum("bhts,bshj->bthj", a_off,
                                                  vq[:, :t0])
            rt, kt, vt = (a[:, t0:t0 + tau] for a in (rq, kq, vq))
            # diagonal tile: explicit (tau, tau) decay, exponents <= 0
            dec = (ecwq[:, t0:t0 + tau][:, :, None]
                   - cwq[:, t0:t0 + tau][:, None, :])  # (b, t, s, h, n)
            dec = torch.where(strictly_lower[None, :, :, None, None], dec,
                              torch.zeros((), dtype=ft, device=dev))
            a_diag = torch.einsum("bthn,btshn->bhts", rt,
                                  kt[:, None] * torch.exp(dec))
            a_diag = torch.where(strictly_lower[None, None], a_diag,
                                 torch.zeros((), dtype=ft, device=dev))
            bonus = torch.einsum("bthn,hn,bthn->bht", rt, uf, kt)
            a_diag = a_diag + bonus[..., None] * eye
            y[:, t0:t0 + tau] += torch.einsum("bhts,bshj->bthj", a_diag, vt)
        # S' = diag(exp(cw_last)) S + sum_s exp(cw_last - cw_s) k_s v_s^T
        cw_last = cwq[:, -1]
        kdec = kq * torch.exp(cw_last[:, None] - cwq)
        state = state * torch.exp(cw_last)[..., None] + torch.einsum(
            "bshi,bshj->bhij", kdec, vq)
        ys.append(y)
    o = torch.stack(ys, dim=1).reshape(b, s, h, n)
    return o.to(r.dtype), state


# ---------------------------------------------------------------------------
# RWKV6 block (time-mix + channel-mix)
# ---------------------------------------------------------------------------

def init_rwkv6(gen, d_model: int, d_ff: int, rc: RWKV6Config, dtype,
               device) -> dict:
    d = d_model
    h = d // rc.head_dim
    tr = rc.token_shift_rank
    full = lambda shape, value, dt=dtype: torch.full(
        shape, value, dtype=dt, device=device)
    dense = lambda shape, scale=None: dense_init(gen, shape, dtype, device,
                                                 scale)
    return {
        "tm": {
            "mu_x": full((d,), 0.0),
            "mu_rwkvg": full((5, d), 0.5),
            "ts_w1": dense((d, 5 * tr), 0.01),
            "ts_w2": dense((5, tr, d), 0.01),
            "w0": full((d,), -2.0, torch.float32),
            "td_w1": dense((d, rc.decay_rank), 0.01),
            "td_w2": dense((rc.decay_rank, d), 0.01),
            "w_r": dense((d, d)),
            "w_k": dense((d, d)),
            "w_v": dense((d, d)),
            "w_g": dense((d, d)),
            "w_o": dense((d, d)),
            "u": full((h, rc.head_dim), 0.0, torch.float32),
            "ln_x_scale": full((d,), 1.0),
            "ln_x_bias": full((d,), 0.0),
        },
        "cm": {
            "mu_k": full((d,), 0.5),
            "mu_r": full((d,), 0.5),
            "w_k": dense((d, d_ff)),
            "w_v": dense((d_ff, d)),
            "w_r": dense((d, d)),
        },
    }


def _ddlerp(tm, x, x_prev):
    """Data-dependent token-shift interpolation → 5 mixed streams
    (r, w, k, v, g)."""
    sx = x_prev - x
    xxx = x + sx * tm["mu_x"]
    b, s, _ = x.shape
    tr = tm["ts_w1"].shape[1] // 5
    t = torch.tanh(xxx @ tm["ts_w1"]).reshape(b, s, 5, tr)
    offs = torch.einsum("bsfr,frd->fbsd", t, tm["ts_w2"])  # (5, B, S, D)
    return x[None] + sx[None] * (tm["mu_rwkvg"][:, None, None] + offs)


def _headify(x, head_dim):
    b, s, d = x.shape
    return x.reshape(b, s, d // head_dim, head_dim)


def rwkv6_time_mix(tm, x, x_prev_tok, rc: RWKV6Config, wkv_state=None):
    """x, x_prev_tok: (B, S, D).  Without ``wkv_state`` (prefill) the WKV
    runs through the kernel wrapper from a zero state; with one (decode)
    through the recurrence.  Returns (out (B,S,D), state (B,H,N,N))."""
    b, s, d = x.shape
    xr, xw, xk, xv, xg = _ddlerp(tm, x, x_prev_tok)
    r = _headify(xr @ tm["w_r"], rc.head_dim)
    kk = _headify(xk @ tm["w_k"], rc.head_dim)
    vv = _headify(xv @ tm["w_v"], rc.head_dim)
    g = F.silu(xg @ tm["w_g"])
    ww = tm["w0"] + torch.tanh(xw @ tm["td_w1"]) @ tm["td_w2"]
    lw = _headify(-torch.exp(ww.float()), rc.head_dim)  # <= 0
    if wkv_state is None:
        o, state = wkv6(r, kk, vv, lw, tm["u"], chunk=rc.chunk_size)
    else:
        o, state = wkv6_recurrent(r, kk, vv, lw, tm["u"],
                                  init_state=wkv_state)
    # per-head group norm
    oh = o.reshape(b, s, d // rc.head_dim, rc.head_dim).float()
    mean = oh.mean(dim=-1, keepdim=True)
    var = oh.var(dim=-1, keepdim=True, unbiased=False)
    oh = (oh - mean) * torch.rsqrt(var + 1e-5)
    o = oh.reshape(b, s, d).to(x.dtype)
    o = o * tm["ln_x_scale"] + tm["ln_x_bias"]
    return (o * g) @ tm["w_o"], state


def rwkv6_channel_mix(cm, x, x_prev_tok):
    sx = x_prev_tok - x
    xk = x + sx * cm["mu_k"]
    xr = x + sx * cm["mu_r"]
    kk = torch.relu(xk @ cm["w_k"]).square()
    return torch.sigmoid(xr @ cm["w_r"]) * (kk @ cm["w_v"])


def token_shift(x, last_x=None):
    """(B, S, D) → the previous-token stream; position 0 gets ``last_x``
    (or zeros)."""
    first = torch.zeros_like(x[:, :1]) if last_x is None else last_x[:, None]
    return torch.cat([first, x[:, :-1]], dim=1)
