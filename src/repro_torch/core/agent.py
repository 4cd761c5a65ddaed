"""Hybrid Learning agent — Algorithm 1 (Deep Dyna-Q) on the paper's
single-cell MDP — plus the training harness shared with the baselines.

Counterpart of ``repro.core.agent``.  Phases per epoch (α = epoch / N):

  (1) Direct RL      — (1 − α/2)·N_direct sessions of T_direct real
      steps; the DQN trains on prioritized minibatches from D_direct.
  (2) System model   — (1 − α/2)·N_world minibatch updates of
      System(s, a; θs) from the uniform D_world.
  (3) Planning       — ((α+1)/2)·N_suggest sessions: the model proposes
      the K most promising actions at the current state; novel (s, a)
      pairs are verified with one real request each (line 29) and stored
      in D_plan; the policy then trains on ((α+1)/2)·N_plan prioritized
      minibatches from D_plan.

Every call that touches the real environment (direct steps and planning
verifications) counts in ``real_steps``, the quantity of Table VI.

The environment and the buffers are numpy on the host, drawing in the
reference's order; the DQN and the system model (``make_dqn``,
``make_system_model``) run on ``device`` — the card by default, the CPU
only when asked for.  A minibatch crosses to the device as five tensors;
the TD errors come back as numpy for the priorities, a copy that
synchronizes, so ``comp_time_s`` times the update's device work as the
reference's ``np.asarray(td)`` does.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Optional

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.core.dqn import make_dqn
from repro_torch.core.replay import (PlanBuffer, PrioritizedReplayBuffer,
                                     ReplayBuffer)
from repro_torch.core.system_model import make_system_model
from repro_torch.device import resolve_device
from repro_torch.env.edge_cloud import EdgeCloudEnv, brute_force_optimal
from repro_torch.policy.adapters import dqn_policy
from repro_torch.policy.api import act_single


@dataclasses.dataclass(frozen=True)
class HLHyperParams:
    epochs: int = 60
    n_direct: int = 8        # direct-RL sessions per epoch (before α scaling)
    t_direct: int = 10       # real steps per direct session
    n_world: int = 24        # system-model minibatches per epoch
    n_suggest: int = 6       # planning sessions per epoch
    t_suggest: int = 5       # planning rollout length
    n_plan: int = 24         # policy minibatches from D_plan per epoch
    k_best: int = 3          # K most promising actions verified per state
    batch: int = 64
    gamma: float = 0.95
    lr: float = 1e-3
    model_lr: float = 2e-3
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 1500
    target_sync_every: int = 4  # sessions
    buffer_cap: int = 20000
    hidden: tuple = (128, 128)
    seed: int = 0


@dataclasses.dataclass
class TrainResult:
    steps_to_converge: Optional[int]
    real_steps: int
    history: list  # [(real_steps, greedy ART, optimal?)]
    final_art: float
    final_actions: np.ndarray
    compute_updates: int  # number of gradient updates (Table VII)
    exp_time_ms: float = 0.0  # simulated experience time (Table VII "Exp")
    comp_time_s: float = 0.0  # wall-clock in gradient updates ("Comp")


class ConvergenceTracker:
    """Converged when the greedy policy's quiet-round ART is within rtol of
    the brute-force optimum for ``patience`` consecutive evaluations."""

    def __init__(self, env: EdgeCloudEnv, rtol: float = 0.01,
                 patience: int = 3):
        self.env = env
        opt = brute_force_optimal(env.cfg.scenario, env.cfg.constraint,
                                  env.cfg.n_users)
        self.opt_art = opt["art"]
        self.rtol = rtol
        self.patience = patience
        self.hits = 0
        self.converged_at: Optional[int] = None
        self.first_hit_steps: Optional[int] = None
        self.history: list = []

    def check(self, real_steps: int, policy, params) -> bool:
        info = self.env.rollout_greedy(policy, params)
        ok = (not info["violated"] and
              info["art"] <= self.opt_art * (1 + self.rtol) + 1e-9)
        self.history.append((real_steps, info["art"], bool(ok)))
        if ok:
            if self.hits == 0:
                self.first_hit_steps = real_steps
            self.hits += 1
            if self.hits >= self.patience and self.converged_at is None:
                self.converged_at = self.first_hit_steps
        else:
            self.hits = 0
            self.first_hit_steps = None
        return self.converged_at is not None


def epsilon(hp, real_steps: int) -> float:
    """Linear ε decay from ``eps_start`` to ``eps_end`` over
    ``eps_decay_steps`` real steps."""
    frac = min(1.0, real_steps / hp.eps_decay_steps)
    return hp.eps_start + frac * (hp.eps_end - hp.eps_start)


def prioritized_update(agent, buf: PrioritizedReplayBuffer) -> None:
    """One DQN step of ``agent`` (an HL or DQL agent) on a prioritized
    minibatch of ``buf``: the batch to the agent's device, the TD errors
    back as the new priorities, the time in ``comp_time_s``."""
    t0 = _time.perf_counter()
    batch, idx, w = buf.sample(agent.hp.batch)
    dev = agent.device
    agent.dqn, _, td = agent.dqn_update(
        agent.dqn, tuple(torch.as_tensor(x, device=dev) for x in batch),
        torch.as_tensor(w, device=dev))
    buf.update_priorities(idx, td.cpu().numpy())
    agent.comp_time_s += _time.perf_counter() - t0
    agent.compute_updates += 1


def train_result(agent, tracker: ConvergenceTracker) -> TrainResult:
    """The agent's final quiet round and its counters."""
    info = agent.env.rollout_greedy(agent.policy, agent.policy_params)
    return TrainResult(tracker.converged_at, agent.real_steps,
                       tracker.history, info["art"], info["actions"],
                       agent.compute_updates, exp_time_ms=agent.exp_time_ms,
                       comp_time_s=agent.comp_time_s)


class HLAgent:
    """Deep Dyna-Q hybrid learner (the paper's contribution).  Its
    networks come from ``k1, k2 = split(PRNGKey(seed))`` on ``device``, as
    the reference's; a missing card raises."""

    def __init__(self, env: EdgeCloudEnv, hp: HLHyperParams = None,
                 device="cuda"):
        self.env = env
        self.hp = hp or HLHyperParams()
        hp = self.hp
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(hp.seed)
        k1, k2 = rnd.split(rnd.PRNGKey(hp.seed, self.device))
        (self.dqn_init, self.q_values, self.dqn_update,
         self.dqn_sync) = make_dqn(env.spec, env.n_actions,
                                   hidden=hp.hidden, lr=hp.lr,
                                   gamma=hp.gamma)
        # the agent decides through the shared Policy protocol, so
        # evaluation, serving and bundles use the same surface
        self.policy = dqn_policy(env.spec, env.n_actions, hidden=hp.hidden)
        (self.sm_init, self.sm_predict, self.sm_predict_all,
         self.sm_update) = make_system_model(env.spec, env.n_actions,
                                             lr=hp.model_lr)
        self.dqn = self.dqn_init(k1)
        self.sm = self.sm_init(k2)
        self.d_direct = PrioritizedReplayBuffer(hp.buffer_cap, env.state_dim,
                                                seed=hp.seed + 1)
        self.d_world = ReplayBuffer(hp.buffer_cap, env.state_dim,
                                    seed=hp.seed + 2)
        self.d_plan = PlanBuffer(hp.buffer_cap, env.state_dim,
                                 seed=hp.seed + 3)
        self.real_steps = 0
        self.compute_updates = 0
        self.exp_time_ms = 0.0   # simulated request time (Table VII "Exp")
        self.comp_time_s = 0.0   # wall-clock spent in gradient updates

    # ------------------------------------------------------------------
    def _act(self, obs) -> int:
        if self.rng.random() < epsilon(self.hp, self.real_steps):
            return int(self.rng.integers(self.env.n_actions))
        return act_single(self.policy, self.dqn.params, obs)

    @property
    def policy_params(self):
        return self.dqn.params

    def _plan_key(self, obs) -> tuple:
        return tuple(np.round(np.asarray(obs), 3).tolist())

    def _plan_values(self, obs) -> np.ndarray:
        """One-step model lookahead r̂ + γ max Q(ŝ′) of every action at
        ``obs``: the model and the DQN on the device, r̂ and max Q back
        in one copy, the sum in numpy float32 as the reference's."""
        s = torch.as_tensor(obs[None], device=self.device)
        r_hat, s2_hat = self.sm_predict_all(self.sm.params, s)
        q_next = self.q_values(self.dqn.params, s2_hat[0]).max(-1).values
        r_hat, q_next = torch.stack([r_hat[0], q_next]).cpu().numpy()
        return r_hat + self.hp.gamma * q_next

    # ------------------------------------------------------------------
    def _direct_rl_session(self, obs):
        hp = self.hp
        for _ in range(hp.t_direct):
            a = self._act(obs)
            obs2, r, done, info = self.env.step(a)
            self.real_steps += 1
            self.exp_time_ms += info.get("t_ms", 0.0)
            self.d_direct.add(obs, a, r, obs2, done)
            self.d_world.add(obs, a, r, obs2, done)
            obs = obs2
        if len(self.d_direct) >= hp.batch:
            prioritized_update(self, self.d_direct)
        return obs

    def _system_model_session(self):
        hp = self.hp
        if len(self.d_world) < hp.batch:
            return
        t0 = _time.perf_counter()
        batch, _, _ = self.d_world.sample(hp.batch)
        self.sm, _ = self.sm_update(
            self.sm, tuple(torch.as_tensor(x, device=self.device)
                           for x in batch))
        self.comp_time_s += _time.perf_counter() - t0
        self.compute_updates += 1

    def _planning_session(self):
        """Algorithm 1 lines 21–33."""
        hp = self.hp
        plan_env = self.env.fork()  # independent request stream
        obs = plan_env.observe()
        for _ in range(hp.t_suggest):
            order = np.argsort(-self._plan_values(obs))
            best_a = int(order[0])
            suggested = order[:hp.k_best]
            key = self._plan_key(obs)
            for a_i in suggested:
                if self.d_plan.contains(key, a_i):
                    continue  # lines 31–32: refreshed lazily on next add
                fork = plan_env.fork()
                obs2, r, done, info = fork.step(int(a_i))
                self.real_steps += 1  # planning verification = real request
                self.exp_time_ms += info.get("t_ms", 0.0)
                self.d_plan.add_keyed(key, obs, int(a_i), r, obs2, done)
            # advance the planning state with the model-preferred action
            obs, _, _, _ = plan_env.step(best_a)

    def _plan_train_session(self):
        if len(self.d_plan) < self.hp.batch:
            return
        prioritized_update(self, self.d_plan)

    # ------------------------------------------------------------------
    def train(self, *, tracker: ConvergenceTracker,
              eval_every_sessions: int = 2,
              stop_on_convergence: bool = True) -> TrainResult:
        hp = self.hp
        obs = self.env.reset()
        session_count = 0
        for epoch in range(1, hp.epochs + 1):
            alpha = epoch / hp.epochs
            # ---- (1) Direct RL ----
            for _ in range(max(1, int(round((1 - alpha / 2) * hp.n_direct)))):
                obs = self._direct_rl_session(obs)
                session_count += 1
                if session_count % hp.target_sync_every == 0:
                    self.dqn = self.dqn_sync(self.dqn)
                if session_count % eval_every_sessions == 0:
                    if tracker.check(self.real_steps, self.policy,
                                     self.policy_params) and \
                            stop_on_convergence:
                        return train_result(self, tracker)
            # ---- (2) System model learning ----
            for _ in range(max(1, int(round((1 - alpha / 2) * hp.n_world)))):
                self._system_model_session()
            # ---- (3) Planning ----
            for _ in range(max(1, int(round((alpha + 1) / 2 * hp.n_suggest)))):
                self._planning_session()
            for _ in range(max(1, int(round((alpha + 1) / 2 * hp.n_plan)))):
                self._plan_train_session()
            self.dqn = self.dqn_sync(self.dqn)
            if tracker.check(self.real_steps, self.policy,
                             self.policy_params) and \
                    stop_on_convergence:
                return train_result(self, tracker)
        return train_result(self, tracker)
