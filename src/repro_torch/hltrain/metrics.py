"""Per-epoch fleet metrics and the Table-VI accounting for the trainer.

Counterpart of ``repro.hltrain.metrics``:

  * **Real-step accounting (Table VI).**  ``real_step_budget`` gives in
    closed form what the trainer's counters reach: per epoch, the
    ``session_schedule``'s direct sessions × t_direct steps × C cells
    (equal to the trainer's ``direct_steps``), and at most its suggest
    sessions × t_suggest × K × C verifications (the novelty gate only
    skips requests).
  * **Reward vs the exact optimum.**  ``evaluate_vs_solver`` runs a
    policy (default: the greedy argmax of a DQN) for one quiet round per
    cell and scores it against ``fleet.solver``'s exact constrained
    optimum, in the paper's reward units r = −ART/100 − penalty·violated;
    the relative gap per cell is what the ≥95%-of-optimum acceptance of
    fleet training is checked on.
  * ``history_to_dict`` brings a ``run`` call's per-epoch metrics (device
    tensors) to the host as lists.
"""
from __future__ import annotations

import functools

import numpy as np

from repro_torch import random as rnd
from repro_torch.fleet.env import (PENALTY_BASE, PENALTY_PER_PCT,
                                   REWARD_SCALE, FleetConfig)
from repro_torch.fleet.evaluate import make_greedy_evaluator
from repro_torch.fleet.solver import host, solve_fleet
from repro_torch.fleet.workload import FleetScenario
from repro_torch.hltrain.trainer import FleetHLParams, session_schedule


def real_step_budget(hp: FleetHLParams, n_cells: int,
                     epochs: int | None = None) -> dict:
    """Closed-form Table-VI interaction budget for ``epochs`` epochs, from
    the trainer's own session schedule."""
    epochs = hp.epochs if epochs is None else epochs
    sched = session_schedule(hp)
    direct = int(sched["direct"][:epochs].sum()) * hp.t_direct * n_cells
    verify_max = (int(sched["suggest"][:epochs].sum())
                  * hp.t_suggest * hp.k_best * n_cells)
    return {"direct_steps": direct, "verify_steps_max": verify_max,
            "real_steps_max": direct + verify_max}


def optimal_rewards(scenario: FleetScenario) -> np.ndarray:
    """(C,) exact per-cell optimum reward −ART*/100 (the optimum is
    feasible, so it pays no penalty)."""
    return -solve_fleet(scenario)["art"] / REWARD_SCALE


def reward_from_round(art: np.ndarray, acc: np.ndarray,
                      constraint: np.ndarray) -> np.ndarray:
    """Paper reward of a round: −ART/100 − the graded penalty where the
    accuracy constraint is violated (the env's constants), in numpy."""
    violated = acc < constraint - 1e-9
    penalty = np.where(
        violated, PENALTY_BASE + PENALTY_PER_PCT * (constraint - acc), 0.0)
    return -art / REWARD_SCALE - penalty


@functools.lru_cache(maxsize=None)
def _greedy_evaluator(cfg: FleetConfig):
    """One evaluator per config, reused across calls (one per training
    chunk): its env and its draw plans are built once."""
    return make_greedy_evaluator(cfg)


def evaluate_vs_solver(params, scenario: FleetScenario, cfg: FleetConfig,
                       key=None, opt_reward: np.ndarray | None = None
                       ) -> dict:
    """The policy's quiet round against the exact optimum, in reward
    units, per cell and averaged.  Pass ``opt_reward`` (from
    :func:`optimal_rewards`) when scoring the same fleet repeatedly.
    ``key`` defaults to ``PRNGKey(0)`` on the scenario's device.

    Under ``shared_cloud`` / ``shared_edge`` the per-cell optimum ignores
    the coupling: it is a lower bound and the gap is inflated."""
    key = rnd.PRNGKey(0, scenario.device) if key is None else key
    info = {k: host(v) for k, v in
            _greedy_evaluator(cfg)(params, scenario, key).items()}
    if opt_reward is None:
        opt_reward = optimal_rewards(scenario)
    policy_reward = reward_from_round(info["art"], info["acc"],
                                      host(scenario.constraint))
    gap = (opt_reward - policy_reward) / np.abs(opt_reward)
    return {
        "art": info["art"], "acc": info["acc"],
        "violated": info["violated"],
        "policy_reward": policy_reward, "opt_reward": opt_reward,
        "mean_policy_reward": float(policy_reward.mean()),
        "mean_opt_reward": float(opt_reward.mean()),
        "reward_gap": gap,
        "mean_reward_gap": float(gap.mean()),
        "violation_rate": float(info["violated"].mean()),
    }


def history_to_dict(metrics) -> dict:
    """Per-epoch metrics (tensors or arrays) → plain Python lists."""
    return {k: host(v).tolist() for k, v in metrics.items()}
