"""Batched policy evaluation over a fleet, through the Policy protocol.

Counterpart of ``repro.fleet.evaluate``.  One ``policy.act`` call per
round position decides for every cell at once; ``n_max`` steps roll a
complete round for the whole fleet.  The reference scans the steps in
one jitted program; here they are a Python loop over device tensors with
no host sync inside, and each step calls ``env.transition``: the next
observation that ``env.step`` would compute is never read (XLA drops it
from the reference's scan).  Keys follow the reference's schedule: one
``split`` per step for the policy, and ``k_init, k_act = split(key)`` in
the evaluator.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import random as rnd
from repro_torch.fleet.env import FleetConfig, make_fleet_env
from repro_torch.fleet.workload import FleetScenario
from repro_torch.policy.adapters import dqn_policy
from repro_torch.policy.api import Policy, act_batch


def run_policy_round(env, policy: Policy, cfg: FleetConfig, params,
                     scenario: FleetScenario, state, key):
    """One complete fleet round through ``policy.act``: ``cfg.n_max``
    decision steps from ``state``, each cell's *first* completed round
    gathered (a cell completes at step n_users - 1; cells with fewer
    users auto-reset and may complete again).  Decisions go through
    ``act_batch``, so round-size-conditioned policies see this round's
    ``scenario.n_users``.  Returns ``(state', {"art", "acc",
    "violated"})`` with (C,) tensors on the scenario's device."""
    done, art, acc, violated = [], [], [], []
    for _ in range(cfg.n_max):
        key, k_act = rnd.split(key)
        obs = env.observe(scenario, state)
        a = act_batch(policy, params, obs, k_act, n_users=scenario.n_users)
        state, _, d, info = env.transition(scenario, state, a)
        done.append(d)
        art.append(info["art"])
        acc.append(info["acc"])
        violated.append(info["violated"])
    # the first step at which each cell completed (argmax takes the first
    # of equal maxima)
    first = torch.argmax(torch.stack(done).to(torch.uint8), 0)[None, :]
    pick = lambda xs: torch.stack(xs).gather(0, first)[0]
    return state, {"art": pick(art), "acc": pick(acc),
                   "violated": pick(violated)}


def make_greedy_evaluator(cfg: FleetConfig, policy: Policy | None = None):
    """``evaluate(params, scenario, key) -> info``: one quiet round per
    cell through ``policy`` (default: the greedy argmax of a DQN); info
    holds (C,) tensors."""
    policy = dqn_policy(cfg.spec()) if policy is None else policy
    quiet_cfg = dataclasses.replace(cfg, quiet=True)
    env = make_fleet_env(quiet_cfg)

    def evaluate(params, scenario: FleetScenario, key):
        scenario = scenario.with_group_index()
        # independent streams: the env's background and the policy's keys
        k_init, k_act = rnd.split(key.to(scenario.device))
        _, info = run_policy_round(env, policy, quiet_cfg, params, scenario,
                                   env.init(k_init, scenario), k_act)
        return info

    return evaluate


def make_throughput_runner(cfg: FleetConfig, policy: Policy | None = None,
                           n_steps: int = 100):
    """``run(params, scenario, key) -> mean reward``: ``n_steps``
    fleet-wide decisions (C per step) through the policy and the env,
    for throughput measurement.  The env's init and the step keys both
    start from ``key``, as in the reference."""
    policy = dqn_policy(cfg.spec()) if policy is None else policy
    env = make_fleet_env(cfg)

    def run(params, scenario: FleetScenario, key):
        scenario = scenario.with_group_index()
        key = key.to(scenario.device)
        state = env.init(key, scenario)
        rewards = []
        for _ in range(n_steps):
            key, k_act = rnd.split(key)
            obs = env.observe(scenario, state)
            a = policy.act(params, obs, k_act)
            state, r, _, _ = env.transition(scenario, state, a)
            rewards.append(r.mean())
        return torch.stack(rewards).mean()

    return run
