"""Constants of the calibrated latency/accuracy model (the paper's AWS
end-edge-cloud testbed, Tables III-V), copied from the reference model so
the port imports nothing of ``repro``.  ``repro_torch.fleet.latency``
evaluates them on tensors; the tests hold it to the reference numpy
model in float64.  ``action_accuracy`` and ``response_times`` are the
reference's numpy model itself, through which the exact solver reports
its optimum.
"""
from __future__ import annotations

import numpy as np

# MobileNetV1 pool, Table III: (million MACs, is_int8, accuracy %)
MODELS = (
    ("d0", 569, False, 89.9),
    ("d1", 317, False, 88.2),
    ("d2", 150, False, 84.9),
    ("d3", 41, False, 74.2),
    ("d4", 569, True, 88.9),
    ("d5", 317, True, 87.0),
    ("d6", 150, True, 83.2),
    ("d7", 41, True, 72.8),
)
ACCURACY = np.array([m[3] for m in MODELS])
N_MODELS = len(MODELS)

# Local (end-device) execution time per model, ms.
T_LOCAL = np.array([517.2, 302.0, 142.3, 80.4, 269.8, 172.0, 111.8, 72.08])

# Edge / cloud always run d0; end-to-end base times at regular network,
# single occupant.
T_EDGE_D0 = 269.8
T_CLOUD_D0 = 273.05

# Weak-network penalties (ms).
WEAK_S_PENALTY = 80.0    # weak end-node link, any placement
WEAK_E_EDGE = 20.0       # weak edge, offload target = edge
WEAK_E_CLOUD = 40.0      # weak edge, offload target = cloud

# Background-load multipliers (Table II states).
BUSY_CPU_LOCAL = 1.30    # P^S busy → local compute slower
BUSY_MEM = 1.10          # M^* busy → 10% slowdown at that node

# Actions: 0..7 = run d0..d7 locally; 8 = offload to edge (d0);
# 9 = offload to cloud (d0).
N_ACTIONS = N_MODELS + 2
A_EDGE, A_CLOUD = 8, 9


def action_accuracy(actions: np.ndarray) -> np.ndarray:
    """Per-request accuracy (%) for an action vector."""
    return np.where(actions < N_MODELS, ACCURACY[np.minimum(actions, 7)],
                    ACCURACY[0])


def response_times(actions: np.ndarray, weak_s: np.ndarray, weak_e: bool,
                   busy_p_s: np.ndarray | None = None,
                   busy_m_s: np.ndarray | None = None,
                   busy_m_e: bool = False, busy_m_c: bool = False,
                   bg_edge: int = 0, bg_cloud: int = 0) -> np.ndarray:
    """Response time (ms) per end node for a full round of n requests, in
    float64: actions (n,) ints in [0, 10); weak_s (n,) bool; busy_*
    background flags (None → quiet); bg_edge / bg_cloud background
    occupancy added to the contention count."""
    n = len(actions)
    busy_p_s = np.zeros(n, bool) if busy_p_s is None else busy_p_s
    busy_m_s = np.zeros(n, bool) if busy_m_s is None else busy_m_s
    is_local = actions < N_MODELS
    is_edge = actions == A_EDGE
    is_cloud = actions == A_CLOUD
    k_edge = int(is_edge.sum()) + int(bg_edge)
    k_cloud = int(is_cloud.sum()) + int(bg_cloud)

    t = np.zeros(n)
    tl = T_LOCAL[np.minimum(actions, 7)]
    tl = tl * np.where(busy_p_s, BUSY_CPU_LOCAL, 1.0)
    tl = tl * np.where(busy_m_s, BUSY_MEM, 1.0)
    t = np.where(is_local, tl, t)
    te = T_EDGE_D0 * max(1, k_edge) * (BUSY_MEM if busy_m_e else 1.0)
    te = te + (WEAK_E_EDGE if weak_e else 0.0)
    t = np.where(is_edge, te, t)
    tc = T_CLOUD_D0 * max(1, k_cloud) * (BUSY_MEM if busy_m_c else 1.0)
    tc = tc + (WEAK_E_CLOUD if weak_e else 0.0)
    t = np.where(is_cloud, tc, t)
    # the weak end-node link penalty applies to every request of that node
    return t + np.where(weak_s, WEAK_S_PENALTY, 0.0)
