"""The latency model on tensors, batched over a leading cell axis.

Counterpart of ``repro.fleet.latency``.  Every function takes stacked
per-cell tensors — ``(C, n)`` per-slot arrays and ``(C,)`` per-cell
scalars — so the whole fleet is one call, with the batch dimension
written out instead of ``vmap``.  An optional boolean ``mask`` marks the
real slots of padded rounds: masked slots add neither contention nor
response time.

``fleet_totals`` gives a step's cross-cell totals: fleet-wide sums and
edge-group totals (the reference's ``group_occupancy``), the latter by
the hand-written ``group_occupancy`` kernel on CUDA tensors
(``repro_torch.kernels.orchestration``) over the group index a scenario
carries.  Under a cells group (``repro_torch.sharding``) the cells are
one rank's block and edge groups may span ranks: it runs the kernel over
the block's own index, writes each local group's total at its global id
and sums every total across the ranks in one ``all_reduce`` (the
reference's ``axis`` branch: segment totals ``psum``-reduced over the
cells axis, then gathered).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.env import latency_model as lm
from repro_torch.kernels import orchestration
from repro_torch.sharding import runtime

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


def fleet_totals(index: orchestration.GroupIndex, sums=(), group_sums=(),
                 *, group=None, block=None) -> tuple[list, list]:
    """One step's cross-cell totals: each (C,) int32 tensor of ``sums``
    summed over every cell of the fleet (a 0-d int32), and each of
    ``group_sums`` over every cell's edge group (a (C,) int32: ``out[i]
    = sum_j x[j] * [groups[j] == groups[i]]``, own contribution
    included).  Returns ``(sums, group_sums)`` totals.

    Off a cells group: a sum and one ``group_occupancy`` launch over
    ``index`` each (``index`` may be None when there are no
    ``group_sums``).  Under a cells ``group`` the cells are the rank's
    block (``block``, the scenario's ``CellBlock``): the kernel runs over
    the block's index, each local group's total (at its first member) is
    written at its global id into a zeroed ``(K, n_groups)`` int32 buffer
    that ends with the local sums, one ``all_reduce`` adds the ranks'
    buffers, and each cell reads its group's total back.  int32
    throughout, so every total is exact."""
    if group is None:
        return ([x.sum(dtype=torch.int32) for x in sums],
                [orchestration.group_occupancy(x, index)
                 for x in group_sums])
    G, K = block.n_groups, len(group_sums)
    buf = torch.zeros(K * G + len(sums), dtype=torch.int32,
                      device=(*group_sums, *sums)[0].device)
    if K:
        local = torch.stack([orchestration.group_occupancy(x, index)
                             for x in group_sums])
        buf[:K * G].view(K, G)[:, block.group_ids] = \
            local[:, block.group_first]
    if sums:
        buf[K * G:] = torch.stack([x.sum(dtype=torch.int32) for x in sums])
    runtime.all_reduce(buf, group)
    totals = buf[:K * G].view(K, G)[:, block.cell_group]
    return list(buf[K * G:]), list(totals)


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


def round_metrics(actions, weak_s, weak_e, mask=None, **bg):
    """(average response time ms, average accuracy %) of C cells' rounds
    over their real slots, each (C,) float32.

    actions, weak_s: (C, n); weak_e: (C,); mask: (C, n) bool of real
    slots (None: all real); ``bg`` takes :func:`response_times`' busy
    flags and background occupancy by name, quiet where absent (no busy
    flag, no background), as the reference's defaults.  With a mask the
    means divide by ``max(1, mask.sum(-1))``, so a cell with no real slot
    reads 0."""
    c, n = actions.shape
    dev = actions.device
    flags = lambda shape: torch.zeros(shape, dtype=torch.bool, device=dev)
    counts = lambda: torch.zeros(c, dtype=torch.int32, device=dev)
    real = flags((c, n)).logical_not() if mask is None else mask
    t = response_times(
        actions, weak_s, weak_e,
        bg.get("busy_p_s", flags((c, n))), bg.get("busy_m_s", flags((c, n))),
        bg.get("busy_m_e", flags(c)), bg.get("busy_m_c", flags(c)),
        bg.get("bg_edge", counts()), bg.get("bg_cloud", counts()), real)
    acc = action_accuracy(actions)
    if mask is None:
        return t.mean(-1), acc.mean(-1)
    denom = mask.sum(-1).clamp(min=1).to(t.dtype)
    return (t * mask).sum(-1) / denom, (acc * mask).sum(-1) / denom
