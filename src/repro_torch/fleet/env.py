"""The vectorized FleetEnv on tensors: every cell of a fleet steps at once.

Counterpart of ``repro.fleet.env.make_fleet_env`` (semantics, reward and
key schedule identical, test-enforced): ``init`` / ``observe`` /
``transition`` / ``step`` / ``rollout`` are plain functions on a
``FleetState`` of stacked tensors, with the ``shared_cloud`` (fleet-wide
cloud pool) and ``shared_edge`` (edge-group co-location) couplings.
With ``FleetConfig.economy`` set, ``init`` seeds a per-cell
``TierEconomyState`` on ``FleetState.econ`` and ``observe`` feeds the
spec's ``economy`` block from it; the env carries the state through its
transitions unchanged (the serving engine advances it, once a tick).
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

With ``FleetConfig.cells_group`` set (``repro_torch.sharding``) the env
steps one rank's block of a fleet (``FleetScenario.shard``): its
background is drawn per global cell id, and its cross-cell couplings and
load aggregates are totalled over the whole fleet, one ``all_reduce`` per
``observe`` and one per ``transition`` (``latency.fleet_totals``), so the
block's every value equals the same cells' on one device.

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
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import random as rnd
from repro_torch.economy.tiers import (EconomyProfile, TierEconomyState,
                                       init_economy, profile_tables,
                                       ticks_to_warm)
from repro_torch.env.edge_cloud import (PENALTY_BASE, PENALTY_PER_PCT,
                                       REWARD_SCALE)
from repro_torch.fleet import latency
from repro_torch.fleet.workload import FleetScenario
from repro_torch.specs.observation import (ObsInputs, ObservationSpec,
                                           make_spec)


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
    # tier economics (repro_torch.economy): ``init`` seeds FleetState.econ
    # and ``observe`` encodes it; the serving engine advances it
    economy: EconomyProfile | None = None
    # a repro_torch.sharding.CellsGroup: the env steps this rank's block
    # of the fleet and totals the couplings across the group (the
    # reference's cell_axis); None steps the whole fleet
    cells_group: Any = None

    def spec(self) -> ObservationSpec:
        return make_spec(self.obs_spec, self.n_max)

    @property
    def state_dim(self) -> int:
        return self.spec().dim


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
    # tier-economy state (None unless FleetConfig.economy is set)
    econ: TierEconomyState | None = None


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

    def _block(scenario: FleetScenario):
        """The scenario's place in the fleet under a cells group (None off
        a group)."""
        if cfg.cells_group is None:
            return None
        if scenario.group_index is None or scenario.group_index.block is None:
            raise ValueError("under a cells group the env steps one rank's "
                             "block: scenario.shard(rank, size)")
        return scenario.group_index.block

    def _cell0(scenario: FleetScenario) -> int:
        """Global id of the scenario's first cell (0 off a group)."""
        block = _block(scenario)
        return 0 if block is None else block.cell0

    def _totals(scenario: FleetScenario, sums, group_sums):
        """Fleet-wide and edge-group totals of (C,) int32 counts, across
        the cells group when there is one (``latency.fleet_totals``)."""
        if not (sums or group_sums):
            return [], []
        index = _group_index(scenario) if group_sums else None
        return latency.fleet_totals(index, sums, group_sums,
                                    group=cfg.cells_group,
                                    block=_block(scenario))

    def sample_background(key: torch.Tensor, n_cells: int,
                          cell0: int = 0) -> FleetBackground:
        """Background flags keyed per global cell id (``fold_in`` of
        ``cell0 + i``): a cell's draws are a function of (key, its id)
        only."""
        dev = key.device
        if cfg.quiet:
            zc = torch.zeros((n_cells, n_max), dtype=torch.bool, device=dev)
            z = torch.zeros((n_cells,), dtype=torch.bool, device=dev)
            zi = torch.zeros((n_cells,), dtype=torch.int32, device=dev)
            return FleetBackground(zc, zc, z, z, zi, zi)
        p = cfg.bg_busy_prob
        cells = cell0 + torch.arange(n_cells, device=dev)
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
            bg=sample_background(keys[1], n_cells, _cell0(scenario)),
            econ=(init_economy(cfg.economy, n_cells, n_max, dev)
                  if cfg.economy is not None else None))

    def _count(actions, mask, a) -> torch.Tensor:
        return ((actions == a) & mask).sum(-1, dtype=torch.int32)

    def _round_times(scenario, state, actions):
        """Per-slot response times under the partial assignment
        (undecided slots run the d7 placeholder).  Each cell's cloud
        occupancy includes every other cell's assigned cloud requests
        under ``shared_cloud``, and its edge occupancy its group peers'
        assigned edge requests under ``shared_edge``."""
        a_eff = torch.where(actions >= 0, actions, latency.N_MODELS - 1)
        mask = scenario.user_mask()
        own_cloud = (_count(a_eff, mask, latency.A_CLOUD)
                     if cfg.shared_cloud else None)
        own_edge = (_count(a_eff, mask, latency.A_EDGE)
                    if cfg.shared_edge else None)
        tot, group_tot = _totals(
            scenario, [own_cloud] if cfg.shared_cloud else [],
            [own_edge] if cfg.shared_edge else [])
        bg_cloud = state.bg.bg_cloud
        if cfg.shared_cloud:
            bg_cloud = bg_cloud + (tot[0] - own_cloud)
        bg_edge = state.bg.bg_edge
        if cfg.shared_edge:
            bg_edge = bg_edge + (group_tot[0] - own_edge)
        return latency.response_times(
            a_eff, scenario.weak_s, scenario.weak_e,
            state.bg.busy_p_s, state.bg.busy_m_s,
            state.bg.busy_m_e, state.bg.busy_m_c,
            bg_edge, bg_cloud, mask)

    def observe(scenario: FleetScenario, state: FleetState) -> torch.Tensor:
        """(C, spec.dim) observation: the semantic inputs of the spec's
        blocks (occupancies with couplings, committed accuracy, fleet and
        group load aggregates, constraint targets, the tiers' economy
        state), encoded by the spec."""
        mask = scenario.user_mask()
        own_edge = _count(state.actions, mask, latency.A_EDGE)
        own_cloud = _count(state.actions, mask, latency.A_CLOUD)
        cloud_load = "cloud_load" in spec.blocks
        edge_load = "edge_load" in spec.blocks
        # every total this observation needs, in one reduction under a
        # cells group: the couplings' and the load blocks'
        tot, group_tot = _totals(
            scenario,
            [own_cloud] * cfg.shared_cloud
            + [own_cloud + state.bg.bg_cloud] * cloud_load,
            [own_edge] * cfg.shared_edge
            + [own_edge + state.bg.bg_edge] * edge_load)
        k_edge = own_edge + state.bg.bg_edge
        k_cloud = own_cloud + state.bg.bg_cloud
        if cfg.shared_cloud:
            k_cloud = k_cloud + (tot[0] - own_cloud)
        if cfg.shared_edge:
            k_edge = k_edge + (group_tot[0] - own_edge)
        decided = (state.actions >= 0) & mask
        acc_sum = latency.row_sum(
            latency.action_accuracy(state.actions.clamp(min=0)) * decided)
        n_cells = scenario.n_cells
        block = _block(scenario)
        cloud_fleet = edge_group = None
        if cloud_load:
            # fleet-wide mean cloud occupancy: one scalar for every cell
            n_fleet = n_cells if block is None else block.n_cells
            cloud_fleet = (tot[-1] / n_fleet).expand(n_cells)
        if edge_load:
            # each cell's group mean edge occupancy
            size = (_group_index(scenario).size if block is None
                    else block.group_size)
            edge_group = group_tot[-1] / size
        eco = {}
        if cfg.economy is not None and state.econ is not None:
            price = profile_tables(cfg.economy, state.user.device)
            eco = dict(econ_state=state.econ.tier_state,
                       econ_warm_ticks=ticks_to_warm(cfg.economy,
                                                     state.econ),
                       econ_price=price["route_price"].expand(n_cells, -1))
        return spec.encode(ObsInputs(
            user=state.user, n_users=scenario.n_users,
            busy_p_s=state.bg.busy_p_s, busy_m_s=state.bg.busy_m_s,
            weak_s=scenario.weak_s, weak_e=scenario.weak_e,
            busy_m_e=state.bg.busy_m_e, busy_m_c=state.bg.busy_m_c,
            k_edge=k_edge, k_cloud=k_cloud, acc_sum=acc_sum,
            cloud_fleet=cloud_fleet, edge_group=edge_group,
            constraint=scenario.constraint,
            latency_target=scenario.latency_targets(), **eco))

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
        bg_new = sample_background(keys[1], scenario.n_cells,
                                   _cell0(scenario))
        state2 = FleetState(
            key=keys[0],
            actions=torch.where(done[:, None], -1, acts),
            user=torch.where(done, 0, user2),
            charged=torch.where(done, 0.0, charged),
            bg=FleetBackground(*(_pick(done, new, old)
                                 for new, old in zip(bg_new, state.bg))),
            econ=state.econ)  # advanced by the serving engine, not here
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
