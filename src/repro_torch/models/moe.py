"""Mixture-of-Experts with equal-capacity token-dropping dispatch
(``repro.models.moe``'s counterpart, its grouped single-device path).

Tokens are split into dispatch groups (one per sequence in a prefill or
forward, one for a decode step).  Each group routes every token to its
top-k experts, ranks each (token, slot) within its expert by a stable
sort, and scatters the kept ones into a dense (G, E, C, D) buffer; the
experts run as batched products over that buffer and the results are
gathered back, weighted and summed.  Tokens past an expert's capacity C
are dropped (their slot's contribution is zero); a capacity factor of
``num_experts / num_experts_per_tok`` makes the dispatch dropless.

The integer arithmetic is the reference's, step for step: the capacity
as the same Python float expression, ties in the top-k broken towards
the lower expert index (``jax.lax.top_k``'s order, here a stable
descending sort), a stable sort of the expert ids, ranks from
``searchsorted(..., side="left")``, ``keep = pos < C``, pos clipped to
C - 1, and the flat slot ``(g·E + id)·C + pos``.  A dropped row adds
zeros to a kept row's slot, so the scatter is exact whatever order the
additions take.

The reference's sharding constraints (``buf_spec``, ``hidden_spec``)
carry no arithmetic and are left out.  Its explicit-collective path on a
``data`` / ``model`` mesh (``apply_moe_shard_map``) comes with the
port's multi-card LM work, ROADMAP.md queue 1 item 10.5: this module has
no mesh branch.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import MoEConfig


def init_moe(gen: torch.Generator, d_model: int, moe: MoEConfig, dtype,
             device) -> dict:
    """``router`` (D, E) float32, ``experts`` {w_gate, w_up} (E, D, F) and
    w_down (E, F, D), and a ``shared`` swiglu MLP when the config has
    shared experts — the reference's tree names and layout."""
    e, f = moe.num_experts, moe.expert_d_ff
    dense = lambda shape, dt=dtype: L.dense_init(gen, shape, dt, device)
    params = {"router": dense((d_model, e), torch.float32),
              "experts": {"w_gate": dense((e, d_model, f)),
                          "w_up": dense((e, d_model, f)),
                          "w_down": dense((e, f, d_model))}}
    if moe.num_shared_experts:
        params["shared"] = L.init_mlp(gen, d_model, moe.shared_d_ff,
                                      "swiglu", dtype, device)
    return params


def _top_k(probs: torch.Tensor, k: int):
    """Top-k with renormalised weights, ties to the lower expert index.
    probs (..., E) → ids (..., k) int64, weights (..., k)."""
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[..., :k], ids[..., :k]
    return ids, weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)


def capacity(tokens_per_group: int, moe: MoEConfig,
             capacity_factor: float | None = None) -> int:
    """Rows per (group, expert): the reference's expression, in its order."""
    tg, k, e = tokens_per_group, moe.num_experts_per_tok, moe.num_experts
    cf = moe.capacity_factor if capacity_factor is None else capacity_factor
    return int(min(tg, max(1, math.ceil(tg * k / e * cf))))


class Routing(NamedTuple):
    """One dispatch: per group g and (token, slot) j of ``TG·k``."""

    probs: torch.Tensor    # (G, TG, E) float32 router probabilities
    ids: torch.Tensor      # (G, TG, k) int64 chosen experts
    weights: torch.Tensor  # (G, TG, k) float32 renormalised weights
    pos: torch.Tensor      # (G, TG·k) int64 rank within the expert, clipped
    keep: torch.Tensor     # (G, TG·k) bool: rank < capacity
    slot: torch.Tensor     # (G, TG·k) int64 row of the (G·E·C, D) buffer
    capacity: int


def route(router: torch.Tensor, xg: torch.Tensor, moe: MoEConfig,
          capacity_factor: float | None = None) -> Routing:
    """Route the tokens of xg (G, TG, D) and place each (token, slot) in
    its expert's rows."""
    g, tg, _ = xg.shape
    k, e = moe.num_experts_per_tok, moe.num_experts
    logits = (xg @ router.to(xg.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    ids, weights = _top_k(probs, k)
    flat_ids = ids.reshape(g, tg * k)
    sorted_ids, order = torch.sort(flat_ids, dim=1, stable=True)
    first = torch.searchsorted(sorted_ids, sorted_ids, side="left")
    ranks = torch.arange(tg * k, device=xg.device) - first
    pos = torch.empty_like(ranks).scatter_(1, order, ranks)
    cap = capacity(tg, moe, capacity_factor)
    keep = pos < cap
    pos = pos.clamp_max(cap - 1)
    g_idx = torch.arange(g, device=xg.device)[:, None]
    slot = (g_idx * e + flat_ids) * cap + pos
    return Routing(probs, ids, weights, pos, keep, slot, cap)


def aux_loss(r: Routing, moe: MoEConfig) -> torch.Tensor:
    """Switch-style load-balancing loss over every group's tokens."""
    e = moe.num_experts
    top1 = r.ids[..., 0].reshape(-1)
    counts = torch.zeros(e, device=top1.device).index_add_(
        0, top1, torch.ones(top1.shape, device=top1.device))
    frac_tokens = counts / top1.numel()
    frac_probs = r.probs.mean(dim=(0, 1))
    return e * (frac_tokens * frac_probs).sum() * moe.router_aux_loss_coef


def apply_moe(params, x: torch.Tensor, moe: MoEConfig,
              capacity_factor: float | None = None,
              groups: int | None = None):
    """x (B, S, D) → (y (B, S, D), aux loss).  ``groups`` defaults to one
    per sequence (B) for S > 1 and one for a decode step."""
    b, s, d = x.shape
    k, e = moe.num_experts_per_tok, moe.num_experts
    g = groups if groups is not None else (b if s > 1 else 1)
    tg = (b * s) // g
    if b * s != g * tg:
        raise ValueError(f"{b * s} tokens do not split into {g} groups")
    xg = x.reshape(g, tg, d)
    r = route(params["router"], xg, moe, capacity_factor)
    # scatter the kept (token, slot) rows into the (G·E·C, D) buffer
    x_rep = xg.repeat_interleave(k, dim=1)  # (G, TG·k, D)
    upd = torch.where(r.keep[..., None], x_rep, 0.0).to(x.dtype)
    buf = torch.zeros((g * e * r.capacity, d), dtype=x.dtype,
                      device=x.device)
    buf.index_add_(0, r.slot.reshape(-1), upd.reshape(-1, d))
    buf = buf.reshape(g, e, r.capacity, d)
    del x_rep, upd
    # the experts' swiglu as batched products over the expert axis
    w = params["experts"]
    h = F.silu(torch.einsum("gecd,edf->gecf", buf, w["w_gate"]))
    h.mul_(torch.einsum("gecd,edf->gecf", buf, w["w_up"]))
    out = torch.einsum("gecf,efd->gecd", h, w["w_down"])
    del h, buf
    # gather back, weight and combine the k slots of each token
    y_rep = out.reshape(g * e * r.capacity, d)[r.slot.reshape(-1)]
    y_rep = torch.where(r.keep.reshape(-1, 1), y_rep, 0.0)
    y_rep = y_rep * r.weights.reshape(-1, 1).to(y_rep.dtype)
    y = y_rep.reshape(g, tg, k, d).sum(dim=2)
    if "shared" in params:
        y = y + L.apply_mlp(params["shared"], xg, "swiglu")
    return y.reshape(b, s, d), aux_loss(r, moe)
