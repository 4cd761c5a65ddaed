"""Fleet-scale Hybrid Learning (counterpart of ``repro.hltrain``).

    metrics   reward-vs-exact-optimum evaluation against fleet.solver

The buffers, the trainer and the Table-VI accounting arrive with the
trainer.
"""
from repro_torch.hltrain.metrics import (evaluate_vs_solver, optimal_rewards,
                                         reward_from_round)

__all__ = ["optimal_rewards", "reward_from_round", "evaluate_vs_solver"]
