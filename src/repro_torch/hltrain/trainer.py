"""Hybrid Learning (Deep Dyna-Q, Algorithm 1) over the fleet env, on tensors.

Counterpart of ``repro.hltrain.trainer``.  The three phases of every
epoch run on the vectorized ``FleetEnv`` with everything on the device:

  (1) **Direct RL** — sessions of fleet steps; every step collects C real
      transitions under *per-cell* ε-schedules (each cell jitters its
      decay horizon) and ring-writes them into D_direct and D_world,
      followed by prioritized DQN updates.
  (2) **System model** — minibatch updates of System(s, a; θs) on
      uniform draws from D_world.
  (3) **Planning** — the model scores every action at every cell's
      state, the K best are novelty-checked against D_plan's hashed
      (s, a) keys and only novel pairs are *verified with one real
      request* (Algorithm 1 line 29): a fork of the planning stream,
      free because ``FleetState`` is never written in place.  The policy
      then trains on prioritized minibatches from D_plan.

One DQN and one system model are shared by all cells.  The reference
compiles each phase as a fixed-length scan whose slots beyond the epoch's
α-scaled count (``session_schedule``) revert the whole carry, key
included; here only the active sessions run, which leaves the same
carry.  Per-epoch metrics average the active sessions (the reference's
``nanmean``).  Updates whose buffer holds fewer than ``batch`` rows split
the key and leave the parameters as they were, selected on the device.

Keys are split and consumed as the reference does — ``init`` splits in
5, a direct step in 3, an update in 2 — so exploration draws (ε jitter,
random actions, the exploration mask) are the reference's bits.  ``run``
makes no host sync: readiness flags, cursors, sizes and counters are
device values selected with ``torch.where``, and its per-epoch metrics
come back as device tensors (``history_to_dict`` brings them to the
host).  Real-step accounting is Table VI's: C per direct step, one per
novel verified pair.

With ``FleetHLParams.telemetry`` a ``repro_torch.telemetry`` buffer rides
in the carry: one window per direct session (its global index, a device
value) with the session's real direct steps and its epsilon, mean reward
and TD-loss gauges, and a log-spaced histogram of |TD error| over every
applied update, direct and planning; ``train_telemetry_report`` reads it.
A ``live`` ``TrainLiveEmitter`` gets each epoch's direct sessions after
they ran, in one device-to-host copy an epoch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.core.dqn import DQNState, make_dqn
from repro_torch.core.system_model import SystemModelState, make_system_model
from repro_torch.device import synchronize
from repro_torch.fleet import latency
from repro_torch.fleet.env import FleetConfig, FleetState, make_fleet_env
from repro_torch.fleet.workload import FleetScenario
from repro_torch.hltrain.buffers import (PlanRing, PrioRing, Ring,
                                         hash_state_action, plan_add,
                                         plan_contains, plan_init, prio_add,
                                         prio_init, prio_sample, prio_update,
                                         ring_add, ring_init, ring_sample)
from repro_torch.policy.adapters import dqn_policy
from repro_torch.policy.api import Policy
from repro_torch.telemetry.metrics import (MetricBuffer, buffer_series,
                                           count_event,
                                           histogram_percentiles,
                                           metrics_init, observe_values,
                                           set_gauge)


@dataclasses.dataclass(frozen=True)
class FleetHLParams:
    """Hyper-parameters, as the reference's (defaults included)."""
    epochs: int = 60
    n_direct: int = 8        # direct-RL session slots per epoch
    t_direct: int = 10       # real fleet steps per direct session
    n_world: int = 24        # system-model minibatches per epoch
    n_suggest: int = 6       # planning session slots per epoch
    t_suggest: int = 5       # planning rollout length
    n_plan: int = 24         # policy minibatches from D_plan per epoch
    k_best: int = 3          # K most promising actions verified per state
    batch: int = 128         # fleet-wide minibatch size
    # DQN minibatches per direct session / per plan-train slot (1 = the
    # exact Algorithm-1 cadence)
    updates_per_direct: int = 1
    updates_per_plan: int = 1
    gamma: float = 0.95
    lr: float = 1e-3
    model_lr: float = 2e-3
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 1500   # in per-cell direct steps
    eps_cell_jitter: float = 0.5  # per-cell decay-horizon jitter (±50%)
    alpha: float = 0.6            # PER exponent
    beta: float = 0.4             # PER importance-weight exponent
    target_sync_every: int = 4    # direct sessions between target syncs
    direct_cap: int = 65536
    world_cap: int = 65536
    plan_cap: int = 4096
    hidden: tuple = (128, 128)
    seed: int = 0
    # per-direct-session telemetry (epsilon / reward / TD-loss gauges, a
    # |TD-error| histogram); read back with ``train_telemetry_report``
    telemetry: bool = False


class HLTrainState(NamedTuple):
    """The whole trainer carry: parameters, buffers, env, counters."""
    key: torch.Tensor
    dqn: DQNState
    sm: SystemModelState
    d_direct: PrioRing
    d_world: Ring
    d_plan: PlanRing
    env: FleetState
    obs: torch.Tensor             # (C, D)
    eps_scale: torch.Tensor       # (C,) per-cell ε-decay multiplier
    steps_per_cell: torch.Tensor  # () int32 — direct steps taken per cell
    direct_steps: torch.Tensor    # () int32 — real direct transitions
    verify_steps: torch.Tensor    # () int32 — real verifications
    sessions: torch.Tensor        # () int32 — direct sessions completed
    tel: MetricBuffer | None = None  # per-session metrics (None = off)

    @property
    def real_steps(self) -> torch.Tensor:
        """Table-VI real-interaction count (direct + verification)."""
        return self.direct_steps + self.verify_steps


class FleetHLTrainer(NamedTuple):
    init: Callable     # (key, scenario) -> HLTrainState
    run: Callable      # (state, scenario, epoch_start, n_epochs) ->
    #                    (state, per-epoch metrics: dict of device tensors)
    resume: Callable   # (state, scenario) -> state, after a scenario swap
    policy: Policy     # the "dqn" adapter: act on state.dqn.params


def session_schedule(hp: FleetHLParams) -> dict:
    """Per-epoch α-scaled session counts max(1, round(frac · n)), in
    float64 on the host so that they round as the reference's (and the
    Python ``HLAgent`` loop's) do at the half-integer boundaries.  The
    one source of the trainer's session counts and of
    ``metrics.real_step_budget``."""
    e = np.arange(1, hp.epochs + 1, dtype=np.float64)
    alpha = e / hp.epochs

    def count(frac, n):
        return np.maximum(1, np.round(frac * n)).astype(np.int32)

    return {"direct": count(1 - alpha / 2, hp.n_direct),
            "world": count(1 - alpha / 2, hp.n_world),
            "suggest": count((alpha + 1) / 2, hp.n_suggest),
            "plan": count((alpha + 1) / 2, hp.n_plan)}


def _nanmean(xs: list) -> torch.Tensor:
    return torch.nanmean(torch.stack(xs))


def make_hl_trainer(cfg: FleetConfig, hp: FleetHLParams | None = None, *,
                    live=None) -> FleetHLTrainer:
    """``live`` is an optional ``repro_torch.telemetry.TrainLiveEmitter``
    (requires ``hp.telemetry``): each epoch hands it the metrics of its
    direct sessions, so they stream out as NDJSON while training runs."""
    hp = hp or FleetHLParams()
    if live is not None and not hp.telemetry:
        raise ValueError("live training export requires "
                         "FleetHLParams.telemetry (the per-session "
                         "gauges it streams)")
    env = make_fleet_env(cfg)
    spec = cfg.spec()  # observation width comes from the spec
    state_dim = spec.dim
    n_actions = latency.N_ACTIONS
    policy = dqn_policy(spec, n_actions, hidden=hp.hidden)
    dqn_init, q_values, dqn_update, dqn_sync = make_dqn(
        spec, n_actions, hidden=hp.hidden, lr=hp.lr, gamma=hp.gamma)
    sm_init, _, sm_predict_all, sm_update = make_system_model(
        spec, n_actions, lr=hp.model_lr)
    schedule = session_schedule(hp)

    # ---------------------------------------------------------------- init
    def init(key: torch.Tensor, scenario: FleetScenario) -> HLTrainState:
        scenario = scenario.with_group_index()
        dev = scenario.device
        n_cells = scenario.n_cells
        k_dqn, k_sm, k_env, k_eps, key = rnd.split(key.to(dev), 5)
        env_state = env.init(k_env, scenario)
        jitter = hp.eps_cell_jitter * (
            2.0 * rnd.uniform(k_eps, (n_cells,)) - 1.0)
        zero = lambda: torch.zeros((), dtype=torch.int32, device=dev)
        # one telemetry window per direct-session slot; |TD| magnitudes
        # live well inside [1e-3, 1e3] at the reward scale
        tel = (metrics_init(hp.epochs * hp.n_direct,
                            counters=("direct_steps",),
                            gauges=("epsilon", "mean_reward", "q_loss"),
                            lo=1e-3, hi=1e3, bins=128, device=dev)
               if hp.telemetry else None)
        return HLTrainState(
            key=key, dqn=dqn_init(k_dqn), sm=sm_init(k_sm),
            d_direct=prio_init(hp.direct_cap, state_dim, dev),
            d_world=ring_init(hp.world_cap, state_dim, dev),
            d_plan=plan_init(hp.plan_cap, state_dim, dev),
            env=env_state, obs=env.observe(scenario, env_state),
            eps_scale=1.0 + jitter, steps_per_cell=zero(),
            direct_steps=zero(), verify_steps=zero(), sessions=zero(),
            tel=tel)

    def resume(state: HLTrainState, scenario: FleetScenario) -> HLTrainState:
        """Re-anchor the carry after a scenario swap (user counts only):
        abort in-flight rounds and recompute the observations."""
        scenario = scenario.with_group_index()
        env_state = env.reset_rounds(state.env)
        return state._replace(env=env_state,
                              obs=env.observe(scenario, env_state))

    def epsilon(st: HLTrainState) -> torch.Tensor:
        frac = torch.clamp(
            st.steps_per_cell / (hp.eps_decay_steps * st.eps_scale), max=1.0)
        return hp.eps_start + frac * (hp.eps_end - hp.eps_start)

    # ------------------------------------------------------------ phase (1)
    def direct_step(st: HLTrainState, scenario: FleetScenario):
        n_cells = scenario.n_cells
        key, k_eps, k_act = rnd.split(st.key, 3)
        greedy = torch.argmax(q_values(st.dqn.params, st.obs), -1)
        rand_a = rnd.randint(k_act, (n_cells,), 0, n_actions)
        explore = rnd.uniform(k_eps, (n_cells,)) < epsilon(st)
        a = torch.where(explore, rand_a, greedy).to(torch.int32)
        env2, obs2, r, done, _ = env.step(scenario, st.env, a)
        st = st._replace(
            key=key, env=env2, obs=obs2,
            d_direct=prio_add(st.d_direct, st.obs, a, r, obs2, done),
            d_world=ring_add(st.d_world, st.obs, a, r, obs2, done),
            steps_per_cell=st.steps_per_cell + 1,
            direct_steps=st.direct_steps + n_cells)
        return st, r.mean()

    def dqn_train(st: HLTrainState, buf: PrioRing):
        """One prioritized DQN update, applied once ``buf`` holds a
        batch.  Returns (state, buf with new priorities, loss: NaN before
        the warm-up)."""
        key, k_s = rnd.split(st.key)
        batch, idx, w = prio_sample(buf, k_s, hp.batch, alpha=hp.alpha,
                                    beta=hp.beta)
        ready = buf.ring.size >= hp.batch
        dqn, loss, td = dqn_update(st.dqn, batch, w, apply=ready)
        buf = prio_update(buf, idx, td, mask=ready.expand(hp.batch))
        # pre-warm-up minibatches gather unwritten slots: their loss stays
        # out of the metrics
        loss = torch.where(ready, loss, float("nan"))
        if st.tel is not None:  # |TD error| over every applied update
            observe_values(st.tel, td.abs(), ready.expand(hp.batch))
        return st._replace(key=key, dqn=dqn), buf, loss

    def direct_session(st: HLTrainState, scenario: FleetScenario):
        rs = []
        for _ in range(hp.t_direct):
            st, r = direct_step(st, scenario)
            rs.append(r)
        losses = []
        for _ in range(hp.updates_per_direct):
            st, d_direct, loss = dqn_train(st, st.d_direct)
            st = st._replace(d_direct=d_direct)
            losses.append(loss)
        mean_r, loss = torch.stack(rs).mean(), torch.stack(losses).mean()
        if st.tel is not None:
            # window = this direct session's global index (on the device)
            w = st.sessions.clamp(max=hp.epochs * hp.n_direct - 1)
            count_event(st.tel, "direct_steps", w,
                        hp.t_direct * scenario.n_cells)
            set_gauge(st.tel, "epsilon", w, epsilon(st).mean())
            set_gauge(st.tel, "mean_reward", w, mean_r)
            set_gauge(st.tel, "q_loss", w, loss)
        sessions = st.sessions + 1
        dqn_sync(st.dqn, where=(sessions % hp.target_sync_every) == 0)
        return st._replace(sessions=sessions), mean_r, loss

    # ------------------------------------------------------------ phase (2)
    def world_session(st: HLTrainState):
        key, k_s = rnd.split(st.key)
        batch, _ = ring_sample(st.d_world, k_s, hp.batch)
        ready = st.d_world.size >= hp.batch
        sm, loss = sm_update(st.sm, batch, apply=ready)
        return (st._replace(key=key, sm=sm),
                torch.where(ready, loss, float("nan")))

    # ------------------------------------------------------------ phase (3)
    def plan_step(st: HLTrainState, scenario: FleetScenario, p_env, p_obs):
        """Model-suggest → novelty-gate → verify with a real request."""
        # (C, A) rewards and (C, A, D) next states for every action
        r_hat, s2_hat = sm_predict_all(st.sm.params, p_obs)
        q_next = q_values(st.dqn.params, s2_hat).amax(-1)
        value = r_hat + hp.gamma * q_next   # one-step model lookahead
        # the K best, ties to the lower action as jax.lax.top_k gives them
        cand = torch.sort(value, dim=-1, descending=True,
                          stable=True).indices[:, :hp.k_best].to(torch.int32)
        for k in range(hp.k_best):
            a_k = cand[:, k]
            h = hash_state_action(p_obs, a_k)
            novel = ~plan_contains(st.d_plan, h)
            # a fork of the planning stream: p_env is not written in place
            _, obs2, r, done, _ = env.step(scenario, p_env, a_k)
            st = st._replace(
                d_plan=plan_add(st.d_plan, h, p_obs, a_k, r, obs2, done,
                                mask=novel),
                verify_steps=st.verify_steps + novel.sum(dtype=torch.int32))
        p_env, p_obs, _, _, _ = env.step(scenario, p_env, cand[:, 0])
        return st, p_env, p_obs

    def plan_session(st: HLTrainState, scenario: FleetScenario):
        p_env, p_obs = st.env, st.obs
        for _ in range(hp.t_suggest):
            st, p_env, p_obs = plan_step(st, scenario, p_env, p_obs)
        return st

    def plan_train(st: HLTrainState):
        losses = []
        for _ in range(hp.updates_per_plan):
            st, buf, loss = dqn_train(st, st.d_plan.buf)
            st = st._replace(d_plan=st.d_plan._replace(buf=buf))
            losses.append(loss)
        return st, torch.stack(losses).mean()

    # ----------------------------------------------------------- one epoch
    def epoch(st: HLTrainState, scenario: FleetScenario, epoch_idx: int):
        e = min(epoch_idx, hp.epochs - 1)
        mean_r, q_loss, sm_loss, p_loss = [], [], [], []
        sessions0 = st.sessions  # global index of the epoch's first session
        for _ in range(int(schedule["direct"][e])):
            st, r, loss = direct_session(st, scenario)
            mean_r.append(r)
            q_loss.append(loss)
        if live is not None:
            # one device-to-host copy an epoch: the first session's index,
            # each session's mean reward and TD loss, the epoch's epsilon
            lanes = torch.cat([sessions0.to(torch.float64).reshape(1),
                               torch.stack(mean_r).to(torch.float64),
                               torch.stack(q_loss).to(torch.float64),
                               epsilon(st).mean().to(torch.float64)
                               .reshape(1)]).cpu().numpy()
            n = len(mean_r)
            live.on_epoch(epoch_idx, n, int(lanes[0]),
                          lanes[1:1 + n].astype(np.float32),
                          lanes[1 + n:1 + 2 * n].astype(np.float32),
                          np.float32(lanes[-1]))
        for _ in range(int(schedule["world"][e])):
            st, loss = world_session(st)
            sm_loss.append(loss)
        for _ in range(int(schedule["suggest"][e])):
            st = plan_session(st, scenario)
        for _ in range(int(schedule["plan"][e])):
            st, loss = plan_train(st)
            p_loss.append(loss)
        dqn_sync(st.dqn)  # epoch-end target sync
        metrics = {
            "mean_reward": _nanmean(mean_r),
            "q_loss": _nanmean(q_loss),
            "sm_loss": _nanmean(sm_loss),
            "plan_loss": _nanmean(p_loss),
            "epsilon": epsilon(st).mean(),
            "direct_steps": st.direct_steps,
            "verify_steps": st.verify_steps,
            "real_steps": st.real_steps,
            "d_plan_size": st.d_plan.buf.ring.size,
        }
        return st, metrics

    # ----------------------------------------------------------------- run
    def run(state: HLTrainState, scenario: FleetScenario, epoch_start: int,
            n_epochs: int):
        """``n_epochs`` epochs from ``epoch_start``.  Returns (state,
        metrics): every metric stacked over the epochs as a device tensor
        (``epoch`` an int64 tensor), with no host sync but the live
        emitter's one copy an epoch.

        The input ``state`` is consumed, as the reference's donated carry
        is: its buffers, parameters and moments are written in place, its
        cursors and counters are not, so only the returned state is a
        consistent carry."""
        scenario = scenario.with_group_index()
        history = []
        for i in range(n_epochs):
            state, metrics = epoch(state, scenario, epoch_start + i)
            history.append(metrics)
        out = {"epoch": torch.arange(epoch_start, epoch_start + n_epochs,
                                     device=state.obs.device)}
        for k in history[0] if history else ():
            out[k] = torch.stack([m[k] for m in history])
        return state, out

    return FleetHLTrainer(init=init, run=run, resume=resume, policy=policy)


def train_telemetry_report(state: HLTrainState) -> dict:
    """A telemetry-enabled trainer's metric buffer on the host:
    per-direct-session series (epsilon, mean reward, TD loss, real direct
    steps) cut to the sessions run, and the |TD-error| histogram with its
    p50/p95/p99."""
    if state.tel is None:
        raise ValueError("trainer ran with FleetHLParams.telemetry=False; "
                         "no metric buffer to report")
    s = buffer_series(state.tel)
    n = int(state.sessions)
    out = {"n_sessions": n,
           "direct_steps": s["counters"]["direct_steps"][:n].tolist(),
           "td_hist": s["hist"].tolist(),
           "td_hist_edges": np.round(s["edges"], 6).tolist()}
    for name, v in s["gauges"].items():
        out[name] = [None if np.isnan(x) else float(x) for x in v[:n]]
    for p, v in histogram_percentiles(s["hist"], s["edges"]).items():
        out[f"td_{p}"] = v
    return out


def run_curriculum(trainer: FleetHLTrainer, stages, epochs: int,
                   chunk: int, key, on_stage=None) -> HLTrainState:
    """Drive a chunked curriculum through a trainer: init on the first
    stage, ``resume`` at every real stage swap (aborting in-flight rounds
    before the user counts change), ``run`` up to ``chunk`` epochs per
    stage, the final stage truncated to ``epochs`` in all.  The one
    definition of the stage/chunk/resume protocol (the ``rl_train`` CLI
    trains through it).  ``on_stage(stage_idx, scenario, state,
    metrics)`` observes each chunk after the device has finished it."""
    state = trainer.init(key, stages[0])
    for s, scenario in enumerate(stages):
        # resume only on a real swap: repeating one fixed fleet keeps the
        # in-flight rounds
        if s and scenario is not stages[s - 1]:
            state = trainer.resume(state, scenario)
        start = s * chunk
        state, metrics = trainer.run(state, scenario, start,
                                     min(chunk, epochs - start))
        synchronize(state.obs.device)
        if on_stage is not None:
            on_stage(s, scenario, state, metrics)
    return state
