"""The latency model on tensors, batched over a leading cell axis.

Counterpart of ``repro.fleet.latency``.  Every function takes stacked
per-cell tensors — ``(C, n)`` per-slot arrays and ``(C,)`` per-cell
scalars — so the whole fleet is one call, with the batch dimension
written out instead of ``vmap``.  An optional boolean ``mask`` marks the
real slots of padded rounds: masked slots add neither contention nor
response time.

``group_occupancy`` launches the hand-written CUDA kernel on CUDA
tensors (``repro_torch.kernels.orchestration``).  The cells-mesh branch
of the reference (a ``psum`` over sharded segment totals) arrives with
the sharded slice.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.env import latency_model as lm
from repro_torch.kernels import orchestration

N_MODELS = lm.N_MODELS
N_ACTIONS = lm.N_ACTIONS
A_EDGE, A_CLOUD = lm.A_EDGE, lm.A_CLOUD


@functools.lru_cache(maxsize=None)
def tables(device: torch.device, dtype: torch.dtype = torch.float32) -> dict:
    """The model's constants as tensors on ``device`` (built once, so the
    serving tick makes no host-to-device copy)."""
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return {
        "accuracy": t(lm.ACCURACY),
        "t_local": t(lm.T_LOCAL),
        "t_edge": t(lm.T_EDGE_D0), "t_cloud": t(lm.T_CLOUD_D0),
        "busy_cpu": t(lm.BUSY_CPU_LOCAL), "busy_mem": t(lm.BUSY_MEM),
        "weak_s": t(lm.WEAK_S_PENALTY), "weak_e_edge": t(lm.WEAK_E_EDGE),
        "weak_e_cloud": t(lm.WEAK_E_CLOUD),
        "one": t(1.0), "zero": t(0.0),
    }


def group_occupancy(own: torch.Tensor, groups: torch.Tensor) -> torch.Tensor:
    """(C,) total occupancy of each cell's group, own contribution
    included: ``out[i] = sum_j own[j] * [groups[j] == groups[i]]``."""
    return orchestration.group_occupancy(own, groups)


def group_coupling(own: torch.Tensor, groups: torch.Tensor) -> torch.Tensor:
    """(C,) extra occupancy each cell sees from co-located cells (its
    group total minus its own contribution); zero for singleton groups."""
    return group_occupancy(own, groups) - own


def action_accuracy(actions: torch.Tensor) -> torch.Tensor:
    """Per-request accuracy (%) for non-negative actions (any shape),
    float32."""
    acc = tables(actions.device)["accuracy"]
    return torch.where(actions < N_MODELS,
                       acc[actions.clamp(max=N_MODELS - 1)], acc[0])


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right sum over the last axis.  A fixed order, so float
    sums agree across devices and with the reference's sequential
    reduction."""
    out = x[..., 0]
    for j in range(1, x.shape[-1]):
        out = out + x[..., j]
    return out


def response_times(actions, weak_s, weak_e, busy_p_s, busy_m_s, busy_m_e,
                   busy_m_c, bg_edge, bg_cloud, mask,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(C, n) response time (ms) per user slot of C cells' rounds.

    actions: (C, n) ints in [0, 10); weak_s, busy_p_s, busy_m_s, mask:
    (C, n) bool; weak_e, busy_m_e, busy_m_c: (C,) bool; bg_edge,
    bg_cloud: (C,) integer background occupancy (couplings included).
    Computed in ``dtype`` (float32 on the serving path)."""
    tab = tables(actions.device, dtype)
    sel = lambda cond, a: torch.where(cond, tab[a], tab["one"])
    pen = lambda cond, a: torch.where(cond, tab[a], tab["zero"])
    is_local = (actions < N_MODELS) & mask
    is_edge = (actions == A_EDGE) & mask
    is_cloud = (actions == A_CLOUD) & mask
    k_edge = is_edge.sum(-1, dtype=torch.int32) + bg_edge
    k_cloud = is_cloud.sum(-1, dtype=torch.int32) + bg_cloud

    tl = tab["t_local"][actions.clamp(max=N_MODELS - 1)]
    tl = tl * sel(busy_p_s, "busy_cpu")
    tl = tl * sel(busy_m_s, "busy_mem")
    te = (tab["t_edge"] * k_edge.clamp(min=1).to(dtype)
          * sel(busy_m_e, "busy_mem") + pen(weak_e, "weak_e_edge"))
    tc = (tab["t_cloud"] * k_cloud.clamp(min=1).to(dtype)
          * sel(busy_m_c, "busy_mem") + pen(weak_e, "weak_e_cloud"))

    t = torch.where(is_local, tl, tab["zero"])
    t = torch.where(is_edge, te[:, None], t)
    t = torch.where(is_cloud, tc[:, None], t)
    return t + pen(weak_s & mask, "weak_s")
