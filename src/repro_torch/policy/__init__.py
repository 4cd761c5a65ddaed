"""Policy protocol, adapters and bundles.

    api       the ``Policy`` protocol (init / act / refresh / with_users)
              and ``act_single``, one cell's decision
    adapters  every decision-maker as a Policy: the DQN argmax, the
              tabular Q baseline, the latency-greedy heuristic, the
              exact solver oracle, epsilon-greedy, the SLO guard
    bundle    versioned checkpoints (params + spec name + n_max + schema
              version), byte-compatible with the reference's; the
              ``cost_greedy`` kind loads the router of
              ``repro_torch.economy``
"""
from repro_torch.policy.api import (Policy, act_batch, act_single,
                                    refresh_params)
from repro_torch.policy.adapters import (dqn_policy, epsilon_greedy,
                                         heuristic_greedy_policy,
                                         obs_table_key, oracle_params,
                                         oracle_policy, qtable_policy,
                                         slo_guarded, slo_guarded_params,
                                         solve_oracle)
from repro_torch.policy.bundle import (BUNDLE_VERSION, BundleError,
                                       PolicyBundle, SpecMismatchError,
                                       load_bundle, policy_from_bundle,
                                       save_bundle)

__all__ = [
    "Policy", "act_batch", "act_single", "refresh_params",
    "dqn_policy", "epsilon_greedy", "heuristic_greedy_policy",
    "obs_table_key", "oracle_params", "oracle_policy", "qtable_policy",
    "slo_guarded", "slo_guarded_params", "solve_oracle",
    "BUNDLE_VERSION", "BundleError", "PolicyBundle", "SpecMismatchError",
    "load_bundle", "policy_from_bundle", "save_bundle",
]
