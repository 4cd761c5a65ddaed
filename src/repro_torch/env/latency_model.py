"""Constants of the calibrated latency/accuracy model (the paper's AWS
end-edge-cloud testbed, Tables III-V), copied from the reference model so
the port imports nothing of ``repro``.  ``repro_torch.fleet.latency``
evaluates them on tensors; the tests hold it to the reference numpy
model in float64.
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
