"""Tier economics on tensors: per-tier prices, energy and a
warm/cold/warming startup state machine (``tiers``), and cost-aware
routing with the exact multi-objective solver (``routing``)."""
from repro_torch.economy.tiers import (COLD, WARM, WARMING, N_TIERS,
                                       PROFILE_NAMES, TIER_NAMES,
                                       EconomyProfile, TierEconomyState,
                                       advance_economy, builtin_profile,
                                       init_economy, ticks_to_warm,
                                       tier_of_action)
from repro_torch.economy.routing import (LAM_COST, LAM_ENERGY,
                                         cost_greedy_policy,
                                         economy_tier_weights,
                                         solve_optimal_economy)

__all__ = [
    "COLD", "WARMING", "WARM", "N_TIERS", "TIER_NAMES", "PROFILE_NAMES",
    "EconomyProfile", "TierEconomyState", "builtin_profile",
    "init_economy", "advance_economy", "ticks_to_warm", "tier_of_action",
    "LAM_COST", "LAM_ENERGY", "cost_greedy_policy",
    "economy_tier_weights", "solve_optimal_economy",
]
