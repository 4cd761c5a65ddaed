"""The baselines of Table I on the single-cell MDP.

Counterpart of ``repro.core.baselines``:

* ``DQLAgent`` — Deep-Q learning with prioritized replay and a target
  network but no system model or planning (AdaDeep's class).  Its DQN
  runs on ``device``, as the HL agent's.
* ``QLAgent``  — tabular Q-learning over the quantized Table-II
  observation (AutoScale's class): a float64 row per
  ``obs_table_key``, no generalization.  It stays on the host, as the
  reference's does (the ``qtable`` adapter is host-side).
"""
from __future__ import annotations

import dataclasses
import time as _time

import numpy as np

from repro_torch import random as rnd
from repro_torch.core.agent import (ConvergenceTracker, HLHyperParams,
                                    TrainResult, epsilon,
                                    prioritized_update, train_result)
from repro_torch.core.dqn import make_dqn
from repro_torch.core.replay import PrioritizedReplayBuffer
from repro_torch.device import resolve_device
from repro_torch.env.edge_cloud import EdgeCloudEnv
from repro_torch.policy.adapters import (dqn_policy, obs_table_key,
                                         qtable_policy)
from repro_torch.policy.api import act_single


class DQLAgent:
    """Model-free DQN baseline (AdaDeep-class); its network from
    ``PRNGKey(seed)`` on ``device``."""

    def __init__(self, env: EdgeCloudEnv, hp: HLHyperParams = None,
                 device="cuda"):
        self.env = env
        self.hp = hp or HLHyperParams()
        hp = self.hp
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(hp.seed)
        (self.dqn_init, _, self.dqn_update,
         self.dqn_sync) = make_dqn(env.spec, env.n_actions,
                                   hidden=hp.hidden, lr=hp.lr,
                                   gamma=hp.gamma)
        self.policy = dqn_policy(env.spec, env.n_actions, hidden=hp.hidden)
        self.dqn = self.dqn_init(rnd.PRNGKey(hp.seed, self.device))
        self.buf = PrioritizedReplayBuffer(hp.buffer_cap, env.state_dim,
                                           seed=hp.seed + 1)
        self.real_steps = 0
        self.compute_updates = 0
        self.exp_time_ms = 0.0
        self.comp_time_s = 0.0

    @property
    def policy_params(self):
        return self.dqn.params

    def train(self, *, tracker: ConvergenceTracker, max_steps: int = 200_000,
              eval_every: int = 100,
              stop_on_convergence: bool = True) -> TrainResult:
        hp = self.hp
        obs = self.env.reset()
        while self.real_steps < max_steps:
            a = (int(self.rng.integers(self.env.n_actions))
                 if self.rng.random() < epsilon(hp, self.real_steps)
                 else act_single(self.policy, self.dqn.params, obs))
            obs2, r, done, info = self.env.step(a)
            self.real_steps += 1
            self.exp_time_ms += info.get("t_ms", 0.0)
            self.buf.add(obs, a, r, obs2, done)
            obs = obs2
            if len(self.buf) >= hp.batch and self.real_steps % 5 == 0:
                prioritized_update(self, self.buf)
            if self.real_steps % (hp.target_sync_every * 50) == 0:
                self.dqn = self.dqn_sync(self.dqn)
            if self.real_steps % eval_every == 0:
                if tracker.check(self.real_steps, self.policy,
                                 self.policy_params) and \
                        stop_on_convergence:
                    break
        return train_result(self, tracker)


@dataclasses.dataclass(frozen=True)
class QLHyperParams:
    lr: float = 0.15
    gamma: float = 1.0
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 200_000
    seed: int = 0


class QLAgent:
    """Tabular Q-learning baseline (AutoScale-class).  The table is keyed
    by ``obs_table_key`` of the observation, so it is the params of the
    ``qtable`` adapter itself; it lives on the host."""

    def __init__(self, env: EdgeCloudEnv, hp: QLHyperParams = None):
        self.env = env
        self.hp = hp or QLHyperParams()
        self.rng = np.random.default_rng(self.hp.seed)
        self.q: dict[bytes, np.ndarray] = {}
        self.policy = qtable_policy(env.n_actions)
        self.real_steps = 0
        self.compute_updates = 0
        self.exp_time_ms = 0.0
        self.comp_time_s = 0.0

    def _q(self, key) -> np.ndarray:
        tbl = self.q.get(key)
        if tbl is None:
            tbl = np.zeros(self.env.n_actions, np.float64)
            self.q[key] = tbl
        return tbl

    @property
    def policy_params(self):
        return self.q

    def train(self, *, tracker: ConvergenceTracker, max_steps: int = 2_000_000,
              eval_every: int = 2000,
              stop_on_convergence: bool = True) -> TrainResult:
        hp = self.hp
        obs = self.env.reset()
        key = obs_table_key(obs)
        while self.real_steps < max_steps:
            q = self._q(key)
            if self.rng.random() < epsilon(hp, self.real_steps):
                a = int(self.rng.integers(self.env.n_actions))
            else:
                a = int(np.argmax(q))
            obs2, r, done, info = self.env.step(a)
            self.real_steps += 1
            self.exp_time_ms += info.get("t_ms", 0.0)
            key2 = obs_table_key(obs2)
            t0 = _time.perf_counter()
            target = r if done else r + hp.gamma * self._q(key2).max()
            q[a] += hp.lr * (target - q[a])
            self.comp_time_s += _time.perf_counter() - t0
            self.compute_updates += 1
            key = key2
            if self.real_steps % eval_every == 0:
                if tracker.check(self.real_steps, self.policy,
                                 self.policy_params) and \
                        stop_on_convergence:
                    break
        return train_result(self, tracker)
