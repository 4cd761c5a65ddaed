"""The vectorized FleetEnv on tensors: every cell of a fleet steps at once.

Counterpart of ``repro.fleet.env.make_fleet_env`` (semantics, reward and
key schedule identical, test-enforced): ``init`` / ``observe`` /
``transition`` / ``step`` / ``rollout`` are plain functions on a
``FleetState`` of stacked tensors, with the ``shared_cloud`` (fleet-wide
cloud pool) and ``shared_edge`` (edge-group co-location) couplings.
``step`` is ``transition`` then ``observe``; a caller that discards the
next observation (the serving tick) calls ``transition`` alone, which
the reference's jitted scan gets from XLA dropping an unused output.
Edge groups are read from the scenario's ``group_index``, built once per
deployment (``FleetScenario.with_group_index``); ``observe`` and
``transition`` raise when they need it and it is missing.
``reset_rounds`` aborts in-flight rounds (actions, cursor and charged
reward cleared; key and background kept), which round replay needs
before it swaps a scenario's ``n_users``.  Background flags are drawn per global cell id with the port's threefry
(``repro_torch.random``), so with background noise on the env draws the
reference's exact bits.  Done cells auto-reset with a fresh background.

    env = make_fleet_env(FleetConfig(n_max=5))
    state = env.init(key, scenario)
    obs = env.observe(scenario, state)          # (C, cfg.spec().dim)
    state, obs, reward, done, info = env.step(scenario, state, actions)
    state, reward, done, info = env.transition(scenario, state, actions)
    state = env.reset_rounds(state)
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple

import torch

from repro_torch import random as rnd
from repro_torch.fleet import latency
from repro_torch.fleet.workload import FleetScenario
from repro_torch.specs.observation import (ObsInputs, ObservationSpec,
                                           make_spec)

# Reward constants of the paper's MDP (reference: the single-cell env):
# a violated accuracy constraint costs a fixed charge plus a graded term
# per % of deficit; rewards are in units of 100 ms.
PENALTY_BASE = 0.5
PENALTY_PER_PCT = 2.0
REWARD_SCALE = 100.0


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    n_max: int = 5
    bg_busy_prob: float = 0.1
    quiet: bool = False  # disable background fluctuations (for eval)
    # the cloud is one shared pool: each cell's cloud occupancy includes
    # every other cell's assigned cloud requests
    shared_cloud: bool = False
    # cells with the same ``scenario.edge_group`` share one edge server
    shared_edge: bool = False
    obs_spec: str = "base"

    def spec(self) -> ObservationSpec:
        return make_spec(self.obs_spec, self.n_max)


class FleetBackground(NamedTuple):
    busy_p_s: torch.Tensor  # (C, n_max) bool
    busy_m_s: torch.Tensor  # (C, n_max) bool
    busy_m_e: torch.Tensor  # (C,) bool
    busy_m_c: torch.Tensor  # (C,) bool
    bg_edge: torch.Tensor   # (C,) int32
    bg_cloud: torch.Tensor  # (C,) int32


class FleetState(NamedTuple):
    key: torch.Tensor       # (2,) threefry key for background resampling
    actions: torch.Tensor   # (C, n_max) int32, -1 = undecided
    user: torch.Tensor      # (C,) int32 — requesting-user cursor
    charged: torch.Tensor   # (C,) float32 — dense reward charged so far
    bg: FleetBackground


class FleetEnvFns(NamedTuple):
    init: Callable
    observe: Callable
    transition: Callable
    step: Callable
    reset_rounds: Callable
    rollout: Callable


def _group_index(scenario: FleetScenario):
    if scenario.group_index is None:
        raise ValueError("the scenario has no group index: build it once "
                         "per deployment with scenario.with_group_index()")
    return scenario.group_index


def _pick(done: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    return torch.where(done.reshape((-1,) + (1,) * (new.dim() - 1)),
                       new, old)


def make_fleet_env(cfg: FleetConfig) -> FleetEnvFns:
    n_max = cfg.n_max
    spec = cfg.spec()

    @functools.lru_cache(maxsize=None)
    def _draw_plan(device: torch.device):
        """Which of a cell's six subkeys, and which draw of it, each of
        the 2·n_max + 4 background uniforms uses: ks[0] and ks[1] give
        (n_max,) draws, ks[2..5] one draw each — so one threefry call
        serves them all."""
        sub = torch.tensor([0] * n_max + [1] * n_max + [2, 3, 4, 5],
                           device=device)
        idx = torch.tensor(list(range(n_max)) * 2 + [0] * 4,
                           dtype=torch.int64, device=device)
        return sub, idx

    def sample_background(key: torch.Tensor, n_cells: int) -> FleetBackground:
        """Background flags keyed per global cell id (``fold_in``): a
        cell's draws are a function of (key, its id) only."""
        dev = key.device
        if cfg.quiet:
            zc = torch.zeros((n_cells, n_max), dtype=torch.bool, device=dev)
            z = torch.zeros((n_cells,), dtype=torch.bool, device=dev)
            zi = torch.zeros((n_cells,), dtype=torch.int32, device=dev)
            return FleetBackground(zc, zc, z, z, zi, zi)
        p = cfg.bg_busy_prob
        cells = torch.arange(n_cells, device=dev)
        ks = rnd.split(rnd.fold_in(key, cells), 6)        # (C, 6, 2)
        sub, idx = _draw_plan(dev)
        u = rnd.uniform_at(ks[:, sub], idx)               # (C, 2n+4)
        return FleetBackground(
            u[:, :n_max] < p,
            u[:, n_max:2 * n_max] < p,
            u[:, 2 * n_max] < p,
            u[:, 2 * n_max + 1] < p,
            (u[:, 2 * n_max + 2] < p / 2).to(torch.int32),
            (u[:, 2 * n_max + 3] < p / 2).to(torch.int32),
        )

    def init(key: torch.Tensor, scenario: FleetScenario) -> FleetState:
        n_cells = scenario.n_cells
        dev = scenario.device
        keys = rnd.split(key.to(dev))
        return FleetState(
            key=keys[0],
            actions=torch.full((n_cells, n_max), -1, dtype=torch.int32,
                               device=dev),
            user=torch.zeros((n_cells,), dtype=torch.int32, device=dev),
            charged=torch.zeros((n_cells,), dtype=torch.float32, device=dev),
            bg=sample_background(keys[1], n_cells))

    def _count(actions, mask, a) -> torch.Tensor:
        return ((actions == a) & mask).sum(-1, dtype=torch.int32)

    def _cloud_coupling(actions, mask):
        """(C,) cloud occupancy from *other* cells' assigned cloud
        requests."""
        own = _count(actions, mask, latency.A_CLOUD)
        return own.sum(dtype=torch.int32) - own

    def _edge_coupling(scenario, actions, mask):
        """(C,) edge occupancy from co-located cells' assigned edge
        requests."""
        own = _count(actions, mask, latency.A_EDGE)
        return latency.group_coupling(own, _group_index(scenario))

    def _round_times(scenario, state, actions):
        """Per-slot response times under the partial assignment
        (undecided slots run the d7 placeholder)."""
        a_eff = torch.where(actions >= 0, actions, latency.N_MODELS - 1)
        mask = scenario.user_mask()
        bg_cloud = state.bg.bg_cloud
        if cfg.shared_cloud:
            bg_cloud = bg_cloud + _cloud_coupling(a_eff, mask)
        bg_edge = state.bg.bg_edge
        if cfg.shared_edge:
            bg_edge = bg_edge + _edge_coupling(scenario, a_eff, mask)
        return latency.response_times(
            a_eff, scenario.weak_s, scenario.weak_e,
            state.bg.busy_p_s, state.bg.busy_m_s,
            state.bg.busy_m_e, state.bg.busy_m_c,
            bg_edge, bg_cloud, mask)

    def observe(scenario: FleetScenario, state: FleetState) -> torch.Tensor:
        """(C, spec.dim) observation: the semantic inputs of the spec's
        blocks (occupancies with couplings, committed accuracy, fleet and
        group load aggregates, constraint targets), encoded by the spec."""
        mask = scenario.user_mask()
        own_edge = _count(state.actions, mask, latency.A_EDGE)
        own_cloud = _count(state.actions, mask, latency.A_CLOUD)
        k_edge = own_edge + state.bg.bg_edge
        k_cloud = own_cloud + state.bg.bg_cloud
        if cfg.shared_cloud:
            k_cloud = k_cloud + _cloud_coupling(state.actions, mask)
        if cfg.shared_edge:
            k_edge = k_edge + _edge_coupling(scenario, state.actions, mask)
        decided = (state.actions >= 0) & mask
        acc_sum = latency.row_sum(
            latency.action_accuracy(state.actions.clamp(min=0)) * decided)
        n_cells = scenario.n_cells
        cloud_fleet = edge_group = None
        if "cloud_load" in spec.blocks:
            # fleet-wide mean cloud occupancy: one scalar for every cell
            total = (own_cloud + state.bg.bg_cloud).sum(dtype=torch.int32)
            cloud_fleet = (total / n_cells).expand(n_cells)
        if "edge_load" in spec.blocks:
            index = _group_index(scenario)
            edge_occ = own_edge + state.bg.bg_edge
            edge_group = (latency.group_occupancy(edge_occ, index)
                          / index.size)
        return spec.encode(ObsInputs(
            user=state.user, n_users=scenario.n_users,
            busy_p_s=state.bg.busy_p_s, busy_m_s=state.bg.busy_m_s,
            weak_s=scenario.weak_s, weak_e=scenario.weak_e,
            busy_m_e=state.bg.busy_m_e, busy_m_c=state.bg.busy_m_c,
            k_edge=k_edge, k_cloud=k_cloud, acc_sum=acc_sum,
            cloud_fleet=cloud_fleet, edge_group=edge_group,
            constraint=scenario.constraint,
            latency_target=scenario.latency_targets()))

    def transition(scenario: FleetScenario, state: FleetState, actions_in):
        """One orchestration decision per cell, without the next
        observation.  Returns (state', reward, done, info); done cells
        auto-reset and report their round's art/acc/violated and per-slot
        ``times`` in ``info``."""
        n = scenario.n_users
        u = state.user.clamp(max=n_max - 1).long()[:, None]
        acts = state.actions.scatter(1, u, actions_in.to(torch.int32)[:, None])
        mask = scenario.user_mask()

        times = _round_times(scenario, state, acts)
        t_i = times.gather(1, u)[:, 0]
        charged = state.charged + t_i
        user2 = state.user + 1
        done = user2 >= n

        nf = n.to(torch.float32)
        total = latency.row_sum(times * mask)
        art = total / nf
        acc = latency.row_sum(latency.action_accuracy(
            torch.where(acts >= 0, acts, 0)) * mask) / nf
        violated = acc < scenario.constraint - 1e-9
        settle = total - charged
        penalty = torch.where(
            violated,
            PENALTY_BASE + PENALTY_PER_PCT * (scenario.constraint - acc),
            0.0)
        r_dense = -t_i / (nf * REWARD_SCALE)
        r_term = -(t_i + settle) / (nf * REWARD_SCALE) - penalty
        reward = torch.where(done, r_term, r_dense)

        # auto-reset finished cells: fresh background, cleared round
        keys = rnd.split(state.key)
        bg_new = sample_background(keys[1], scenario.n_cells)
        state2 = FleetState(
            key=keys[0],
            actions=torch.where(done[:, None], -1, acts),
            user=torch.where(done, 0, user2),
            charged=torch.where(done, 0.0, charged),
            bg=FleetBackground(*(_pick(done, new, old)
                                 for new, old in zip(bg_new, state.bg))))
        info = {"art": art, "acc": acc, "violated": violated,
                "t_ms": torch.where(done, t_i + settle.clamp(min=0.0), t_i),
                # (C, n_max) per-slot response times; at ``done`` the
                # completed round's per-request service latency
                "times": times * mask,
                "actions": acts}
        return state2, reward, done, info

    def step(scenario: FleetScenario, state: FleetState, actions_in):
        """:func:`transition`, then the next observation: (state', obs',
        reward, done, info)."""
        state2, reward, done, info = transition(scenario, state, actions_in)
        return state2, observe(scenario, state2), reward, done, info

    def reset_rounds(state: FleetState) -> FleetState:
        """Abort every in-flight round: actions to -1, cursor and charged
        reward to 0; the key and the background stay.  Call it before
        stepping under a new ``n_users``, so no cell settles a round
        against a user count it did not start with."""
        return state._replace(actions=torch.full_like(state.actions, -1),
                              user=torch.zeros_like(state.user),
                              charged=torch.zeros_like(state.charged))

    def rollout(scenario: FleetScenario, state: FleetState, actions):
        """Apply a (T, C) action sequence; returns (state', trajectory)
        with every per-step output stacked on a leading T axis."""
        scenario = scenario.with_group_index()
        steps = []
        for a_t in actions:
            state, obs, reward, done, info = step(scenario, state, a_t)
            steps.append(dict(info, obs=obs, reward=reward, done=done))
        return state, {k: torch.stack([s[k] for s in steps])
                       for k in steps[0]}

    return FleetEnvFns(init=init, observe=observe, transition=transition,
                       step=step, reset_rounds=reset_rounds,
                       rollout=rollout)
