"""Fleet-scale Hybrid Learning (counterpart of ``repro.hltrain``).

    buffers   replay / prioritized / plan buffers on device tensors
              (masked ring writes into a trash row, Gumbel-top-k
              prioritized sampling, hashed (s, a) novelty by sorted
              membership)
    trainer   the three HL phases over sessions, the whole fleet stepped
              per decision; one DQN + system model shared across cells
    metrics   Table-VI real-step accounting and reward-vs-exact-optimum
              evaluation against fleet.solver

With ``FleetHLParams.telemetry`` the trainer keeps per-session metric
series on the device (``train_telemetry_report``).
"""
from repro_torch.hltrain.buffers import (Ring, PrioRing, PlanRing, ring_init,
                                         ring_add, ring_sample, prio_init,
                                         prio_add, prio_sample, prio_update,
                                         plan_init, plan_contains, plan_add,
                                         hash_state_action)
from repro_torch.hltrain.trainer import (FleetHLParams, FleetHLTrainer,
                                         HLTrainState, make_hl_trainer,
                                         run_curriculum, session_schedule,
                                         train_telemetry_report)
from repro_torch.hltrain.metrics import (real_step_budget, optimal_rewards,
                                         reward_from_round,
                                         evaluate_vs_solver, history_to_dict)

__all__ = [
    "Ring", "PrioRing", "PlanRing", "ring_init", "ring_add", "ring_sample",
    "prio_init", "prio_add", "prio_sample", "prio_update",
    "plan_init", "plan_contains", "plan_add", "hash_state_action",
    "FleetHLParams", "FleetHLTrainer", "HLTrainState", "make_hl_trainer",
    "run_curriculum", "session_schedule", "train_telemetry_report",
    "real_step_budget", "optimal_rewards", "reward_from_round",
    "evaluate_vs_solver", "history_to_dict",
]
