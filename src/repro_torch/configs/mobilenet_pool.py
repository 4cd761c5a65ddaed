"""The paper's own workload: the MobileNetV1 d0–d7 pool (Table III).

Counterpart of ``repro.configs.mobilenet_pool``.  Not a transformer
config: the accuracy × latency pool the single-cell orchestrator
schedules.  The latencies live in ``repro_torch.env.latency_model``
(calibrated to Table V); this module gives them a config-style face.
"""
from __future__ import annotations

import dataclasses

from repro_torch.env import latency_model as lm


@dataclasses.dataclass(frozen=True)
class MobileNetVariant:
    name: str
    million_macs: int
    int8: bool
    accuracy: float          # % (Table III)
    local_latency_ms: float  # calibrated end-device latency (Table V fit)


def pool() -> tuple[MobileNetVariant, ...]:
    return tuple(
        MobileNetVariant(name=n, million_macs=m, int8=q, accuracy=a,
                         local_latency_ms=float(lm.T_LOCAL[i]))
        for i, (n, m, q, a) in enumerate(lm.MODELS))


def tiers() -> dict:
    """Edge and cloud serve the most accurate model (d0) only (§II-B)."""
    return {
        "edge": {"model": "d0", "latency_ms": lm.T_EDGE_D0},
        "cloud": {"model": "d0", "latency_ms": lm.T_CLOUD_D0},
    }
