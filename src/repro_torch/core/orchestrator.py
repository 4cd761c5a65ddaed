"""Intelligent Orchestrator (Fig. 1): a trained policy as a serving
component of one cell.

Counterpart of ``repro.core.orchestrator``: per round the orchestrator
reads the cell's state, queries the policy (``act_single``, on the
params' device) and returns one ``OrchestrationDecision`` per request —
which tier runs it (local / edge / cloud) and which model variant.
``variant_pool_from_roofline`` needs the dry-run roofline records, which
the port does not have yet.
"""
from __future__ import annotations

import dataclasses

from repro_torch.env import latency_model as lm
from repro_torch.env.edge_cloud import EdgeCloudEnv

ROOFLINE_LATER = ("variant_pool_from_roofline reads dry-run roofline "
                  "records, which arrive with a later slice of the port "
                  "(ROADMAP.md queue 1 item 10.5: launch/dryrun.py, "
                  "models/flops.py)")


@dataclasses.dataclass(frozen=True)
class OrchestrationDecision:
    user: int
    tier: str          # "local" | "edge" | "cloud"
    variant: int       # index into the tier's model pool
    expected_ms: float
    expected_acc: float


@dataclasses.dataclass(frozen=True)
class ModelVariant:
    name: str
    latency_ms: float   # per-request latency on its tier
    accuracy: float     # task accuracy (%)


class IntelligentOrchestrator:
    """Cloud-hosted RL orchestrator (§II-C steps 3-4) over any
    ``repro_torch.policy`` Policy and its params: a trained agent's
    ``(agent.policy, agent.policy_params)``, a loaded bundle's
    ``policy_from_bundle`` pair, a baseline."""

    def __init__(self, env: EdgeCloudEnv, policy, params):
        self.env = env
        self.policy = policy
        self.params = params

    def decide_round(self) -> list[OrchestrationDecision]:
        """Greedy decisions for one full (quiet) round of requests."""
        info = self.env.rollout_greedy(self.policy, self.params)
        sc = self.env.cfg.scenario
        times = lm.response_times(info["actions"], sc.weak_s_arr(),
                                  sc.weak_e)
        accs = lm.action_accuracy(info["actions"])
        out = []
        for i, a in enumerate(info["actions"]):
            if a < lm.N_MODELS:
                tier, variant = "local", int(a)
            elif a == lm.A_EDGE:
                tier, variant = "edge", 0
            else:
                tier, variant = "cloud", 0
            out.append(OrchestrationDecision(
                user=i, tier=tier, variant=variant,
                expected_ms=float(times[i]), expected_acc=float(accs[i])))
        return out


def variant_pool_from_roofline(records: list[dict],
                               arch: str) -> list[ModelVariant]:
    """Not ported yet (see ``ROOFLINE_LATER``)."""
    raise NotImplementedError(ROOFLINE_LATER)
