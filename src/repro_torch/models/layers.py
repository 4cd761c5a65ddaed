"""Core primitives of the LM substrate (``repro.models.layers``'s
counterpart).

Parameters live in :class:`ParamTree` modules: a nested dict of tensors
registered as an ``nn.Module`` tree, indexed like the reference's
pytrees (``p["attn"]["wq"]``) and stored in its ``(d_in, d_out)``
layout, so every product reads ``x @ W`` as the reference's does.
Weights are drawn from a ``torch.Generator``: the same distributions as
the reference's ``jax.random`` draws, not the same numbers (tests carry
the reference's weights across with ``repro_torch.convert.lm_params``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

_SQRT2 = math.sqrt(2.0)


class ParamTree(nn.Module):
    """A nested dict of tensors as a module tree: ``p["attn"]["wq"]`` is
    ``p.attn.wq``.  Parameters are registered without a gradient, as
    serving wants them; the trainer asks for gradients with
    ``requires_grad_(True)`` (``repro_torch.training.train_step.
    init_train_state``)."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._modules or name in self._parameters


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def truncated_normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normal truncated to [-3, 3] (float32), by the inverse-CDF
    construction ``jax.random.truncated_normal`` uses."""
    lo, hi = math.erf(-3.0 / _SQRT2), math.erf(3.0 / _SQRT2)
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    t.uniform_(lo, hi, generator=gen)
    return t.erfinv_().mul_(_SQRT2).clamp_(-3.0, 3.0)


def dense_init(gen, shape, dtype, device, scale: float | None = None):
    """Truncated-normal fan-in init (the llama/mistral default)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    if scale is None:
        scale = fan_in ** -0.5
    return truncated_normal(gen, shape, device).mul_(scale).to(dtype)


def embed_init(gen, shape, dtype, device):
    return truncated_normal(gen, shape, device).mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def init_rmsnorm(dim: int, dtype, device) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * params["scale"].float()).to(x.dtype)


def init_gated_rmsnorm(dim: int, dtype, device) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def gated_rmsnorm(params, x: torch.Tensor, gate: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Mamba2's norm: RMSNorm(x * silu(gate)) — applied before out_proj;
    the gate goes through silu in float32 and is cast to x's dtype."""
    x = x * F.silu(gate.float()).to(x.dtype)
    return rmsnorm(params, x, eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings (standard and M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), float32."""
    half = head_dim // 2
    expo = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), expo)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., S) int → cos, sin (..., S, head_dim // 2) float32."""
    inv = rope_freqs(head_dim, theta, positions.device)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                  sections: tuple[int, ...]):
    """Multimodal RoPE (Qwen2-VL §2.1): positions (3, ..., S) for (t, h,
    w) → cos, sin (..., S, head_dim // 2) float32.  ``sections`` (half-dim
    sizes summing to head_dim // 2) cut the frequency axis; section i
    takes its angle from positions[i]."""
    if positions.shape[0] != len(sections):
        raise ValueError(f"M-RoPE needs {len(sections)} position rows, got "
                         f"{positions.shape[0]}")
    if sum(sections) != head_dim // 2:
        raise ValueError(f"M-RoPE sections {sections} must sum to "
                         f"{head_dim // 2}")
    inv = rope_freqs(head_dim, theta, positions.device)
    ang = positions.float()[..., None] * inv  # (3, ..., S, half)
    bounds = [0]
    for sec in sections:
        bounds.append(bounds[-1] + sec)
    ang = torch.cat([ang[i, ..., lo:hi] for i, (lo, hi)
                     in enumerate(zip(bounds, bounds[1:]))], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Split-half (rotate_half) RoPE.  x: (B, S, H, D); cos/sin: (S, D/2)
    or (B, S, D/2)."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen, d_model: int, d_ff: int, kind: str, dtype, device) -> dict:
    if kind == "swiglu":
        return {"w_gate": dense_init(gen, (d_model, d_ff), dtype, device),
                "w_up": dense_init(gen, (d_model, d_ff), dtype, device),
                "w_down": dense_init(gen, (d_ff, d_model), dtype, device)}
    if kind in ("squared_relu", "gelu"):
        return {"w_up": dense_init(gen, (d_model, d_ff), dtype, device),
                "w_down": dense_init(gen, (d_ff, d_model), dtype, device)}
    raise ValueError(f"unknown mlp kind {kind!r}")


def apply_mlp(params, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    elif kind == "squared_relu":
        h = torch.relu(x @ params["w_up"]).square()
    elif kind == "gelu":  # jax.nn.gelu's default is the tanh form
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    else:
        raise ValueError(f"unknown mlp kind {kind!r}")
    return h @ params["w_down"]
