"""End-edge-cloud orchestration environment: the paper's round-based MDP
(§II), one cell.

Counterpart of ``repro.env.edge_cloud``.  An episode is one round of
inference requests: each of the n end nodes in turn gets a decision (the
state holds the requesting node and the edge / cloud load assigned so
far), and the terminal transition settles the round's reward

    r = −(ART / 100) − λ · 1[average accuracy < constraint]

with dense per-step shaping whose sum is exactly that.  Background
utilization flips between rounds and perturbs latencies.

The environment is numpy on the host, as the reference's: every
``self.rng`` draw comes in the reference's order, so one seed gives the
reference's observations byte for byte and its rewards exactly.  Only
``rollout_greedy`` reaches a policy (through ``act_single``, on the
params' device).
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from repro_torch.env import latency_model as lm
from repro_torch.env.scenarios import Scenario
from repro_torch.policy.api import act_single
from repro_torch.specs.observation import (DEFAULT_LATENCY_TARGET_MS,
                                           ObsInputs, make_spec)

# Accuracy-constraint penalty (reward units; 1 unit = 100 ms): a fixed
# violation charge plus a graded term per % of accuracy deficit, which
# gives exploration a gradient toward feasibility.
PENALTY_BASE = 0.5
PENALTY_PER_PCT = 2.0
REWARD_SCALE = 100.0


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    scenario: Scenario
    constraint: float  # accuracy threshold in %
    n_users: int = 5
    bg_busy_prob: float = 0.1
    seed: int = 0
    quiet: bool = False  # disable background fluctuations (for eval)
    # observation layout variant (repro_torch.specs.observation)
    obs_spec: str = "base"
    # latency target (ms) of the "constraint" block: a conditioning input
    # only, the reward does not read it
    latency_target: float = DEFAULT_LATENCY_TARGET_MS

    def __post_init__(self):
        # frozen: normalize the scenario to n_users at construction
        object.__setattr__(self, "scenario",
                           self.scenario.for_users(self.n_users))


class EdgeCloudEnv:
    """Round-based multi-user orchestration MDP."""

    def __init__(self, cfg: EnvConfig):
        self.cfg = cfg
        self.n = cfg.n_users
        self.rng = np.random.default_rng(cfg.seed)
        self.n_actions = lm.N_ACTIONS
        self.spec = make_spec(cfg.obs_spec, self.n)
        self.state_dim = self.spec.dim
        self.reset()

    # ---------------- background dynamics ----------------
    def _sample_background(self):
        if self.cfg.quiet:
            z = np.zeros(self.n, bool)
            return dict(busy_p_s=z.copy(), busy_m_s=z.copy(),
                        busy_m_e=False, busy_m_c=False,
                        bg_edge=0, bg_cloud=0)
        p = self.cfg.bg_busy_prob
        return dict(
            busy_p_s=self.rng.random(self.n) < p,
            busy_m_s=self.rng.random(self.n) < p,
            busy_m_e=bool(self.rng.random() < p),
            busy_m_c=bool(self.rng.random() < p),
            bg_edge=int(self.rng.random() < p / 2),
            bg_cloud=int(self.rng.random() < p / 2),
        )

    # ---------------- gym-ish API ----------------
    def reset(self) -> np.ndarray:
        self.bg = self._sample_background()
        self.user = 0
        self.actions = np.full(self.n, -1, np.int64)
        self._charged = 0.0
        return self.observe()

    def observe(self) -> np.ndarray:
        """The observation under ``self.spec`` (``encode_np``): this
        method supplies the occupancies, committed accuracy and targets."""
        sc = self.cfg.scenario
        k_edge = int((self.actions == lm.A_EDGE).sum()) + self.bg["bg_edge"]
        k_cloud = int((self.actions == lm.A_CLOUD).sum()) + self.bg["bg_cloud"]
        decided = self.actions >= 0
        acc_sum = float(lm.action_accuracy(
            np.where(decided, self.actions, 0))[decided].sum())
        # a single cell is the fleet and its own edge group
        return self.spec.encode_np(ObsInputs(
            user=self.user % self.n, n_users=self.n,
            busy_p_s=self.bg["busy_p_s"], busy_m_s=self.bg["busy_m_s"],
            weak_s=sc.weak_s_arr(), weak_e=sc.weak_e,
            busy_m_e=self.bg["busy_m_e"], busy_m_c=self.bg["busy_m_c"],
            k_edge=k_edge, k_cloud=k_cloud, acc_sum=acc_sum,
            cloud_fleet=k_cloud, edge_group=k_edge,
            constraint=self.cfg.constraint,
            latency_target=self.cfg.latency_target))

    def _partial_time(self, user: int) -> float:
        """``user``'s response time under the load assigned so far (the
        undecided users' placeholder action 7 puts no load on the edge
        or the cloud)."""
        sc = self.cfg.scenario
        mask = self.actions >= 0
        t = lm.response_times(np.where(mask, self.actions, 7),
                              sc.weak_s_arr(), sc.weak_e, **self.bg)
        return float(t[user])

    def step(self, action: int):
        """Returns (obs, reward, done, info).  Each decision is charged
        its response time under the partial assignment; the terminal
        transition settles the difference to the round's total
        (contention only raises earlier users' times) and applies the
        accuracy penalty, so the episode return is −ART/100 − penalty."""
        assert 0 <= action < self.n_actions
        self.actions[self.user] = action
        t_i = self._partial_time(self.user)
        self._charged += t_i
        self.user += 1
        done = self.user == self.n
        if not done:
            return (self.observe(), -t_i / (self.n * REWARD_SCALE), False,
                    {"t_ms": t_i})
        sc = self.cfg.scenario
        times = lm.response_times(self.actions, sc.weak_s_arr(), sc.weak_e,
                                  **self.bg)
        art = float(times.mean())
        acc = float(lm.action_accuracy(self.actions).mean())
        violated = acc < self.cfg.constraint - 1e-9
        settle = float(times.sum()) - self._charged  # contention correction
        penalty = (PENALTY_BASE + PENALTY_PER_PCT *
                   (self.cfg.constraint - acc)) if violated else 0.0
        reward = -(t_i + settle) / (self.n * REWARD_SCALE) - penalty
        info = {"art": art, "acc": acc, "violated": violated,
                "actions": self.actions.copy(), "t_ms": t_i + max(0.0, settle)}
        obs = self.reset()
        return obs, reward, True, info

    def fork(self) -> "EdgeCloudEnv":
        """An independent copy for planning forks: shares the immutable
        config, spec and scenario; clones the round state and the exact
        numpy stream.  Callers must not toggle ``cfg.quiet`` (as
        ``rollout_greedy`` does) while a fork is live."""
        new = object.__new__(EdgeCloudEnv)
        new.cfg = self.cfg
        new.n = self.n
        new.n_actions = self.n_actions
        new.spec = self.spec
        new.state_dim = self.state_dim
        rng = np.random.default_rng()
        rng.bit_generator.state = self.rng.bit_generator.state
        new.rng = rng
        new.bg = {k: v.copy() if isinstance(v, np.ndarray) else v
                  for k, v in self.bg.items()}
        new.user = self.user
        new.actions = self.actions.copy()
        new._charged = self._charged
        return new

    # ---------------- evaluation helpers ----------------
    def rollout_greedy(self, policy, params):
        """One quiet round under a ``repro_torch.policy`` Policy, through
        ``act_single``.  Returns the terminal info dict; the env's round
        state and config are restored after."""
        saved = (self.bg, self.user, self.actions.copy(), self.cfg)
        # the config is frozen: swap in a quiet copy, restore it after
        self.cfg = dataclasses.replace(self.cfg, quiet=True)
        self.reset()
        obs = self.observe()
        info = {}
        for _ in range(self.n):
            a = act_single(policy, params, obs)
            obs, r, done, info = self.step(a)
        self.bg, self.user, self.actions, self.cfg = saved
        return info


def brute_force_optimal(scenario: Scenario, constraint: float,
                        n_users: int) -> dict:
    """Exhaustive search over the 10^n joint actions (quiet background):
    the paper's design-time optimum (§IV-B1).  The first joint action in
    ``itertools.product`` order that beats the best by more than 1e-12
    wins, as in the reference."""
    sc = scenario.for_users(n_users)
    weak_s = sc.weak_s_arr()
    best = None
    for joint in itertools.product(range(lm.N_ACTIONS), repeat=n_users):
        a = np.asarray(joint)
        acc = lm.action_accuracy(a).mean()
        if acc < constraint - 1e-9:
            continue
        t = lm.response_times(a, weak_s, sc.weak_e).mean()
        if best is None or t < best["art"] - 1e-12:
            best = {"art": float(t), "acc": float(acc), "actions": a.copy()}
    assert best is not None, "constraint unsatisfiable"
    return best


def decision_string(actions: np.ndarray) -> list[str]:
    """An action vector Table-V style, e.g. ['d4, L', 'd0, E']."""
    out = []
    for a in actions:
        if a < lm.N_MODELS:
            out.append(f"d{a}, L")
        elif a == lm.A_EDGE:
            out.append("d0, E")
        else:
            out.append("d0, C")
    return out
