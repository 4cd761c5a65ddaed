"""The registry of the port's entry points: every program the gate runs.

Counterpart of ``repro.analysis.registry``.  Each :class:`Entry` names one
entry point and knows how to ``build(device)`` it -- a fresh callable
plus small concrete arguments on ``device`` -- so
:func:`repro_torch.analysis.contracts.run_contract` can run and record
it.  Shapes are tiny (4 cells, 3-request rounds, a few dozen requests),
as the reference's: a contract -- which collectives an entry issues,
where it copies to the host, where it syncs, which dtypes it touches,
which fields it keeps in place -- does not depend on the width, and the
committed baseline stays readable.  The reference's two exceptions hold
here too:

- ``serve_epoch_sharded`` uses the benchmark sweep's serving
  configuration (``n_max=5``, ``full`` spec, ``shared_cloud +
  shared_edge``) on a one-rank cells group, so its ``all_reduce`` count
  is the tick's collective budget (two a tick).
- ``serve_epoch_economy`` uses the ``spot`` profile and the
  ``full_economy`` spec, and ``economy_advance`` carries the check that
  billing stays int32.

``serve_epoch_live`` closes a telemetry window every other tick
(``window_ms=100``), so the recorded epoch crosses the ``on_window``
lane; ``hltrain_run_live`` crosses ``on_epoch`` once.  The tick and the
epoch entries (``hot``) may not sync outside those lanes.
``single_cell_update`` -- one DQN update and one system-model update of
the paper's ``HLAgent``, whose buffers are numpy on the host -- is a
host loop by design: its copies and syncs are baselined, not banned.
"""
from __future__ import annotations

import dataclasses
import io
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.analysis import contracts
from repro_torch.analysis.contracts import Built
from repro_torch.core.agent import HLAgent, HLHyperParams, prioritized_update
from repro_torch.economy.routing import cost_greedy_policy
from repro_torch.economy.tiers import (advance_economy, builtin_profile,
                                       init_economy)
from repro_torch.env.edge_cloud import EdgeCloudEnv, EnvConfig
from repro_torch.env.scenarios import CONSTRAINTS, SCENARIOS
from repro_torch.fleet.env import FleetConfig
from repro_torch.fleet.workload import random_fleet
from repro_torch.hltrain.trainer import FleetHLParams, make_hl_trainer
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.orchestration import (group_index, group_occupancy,
                                               queue_admit)
from repro_torch.policy.adapters import heuristic_greedy_policy, oracle_policy
from repro_torch.policy.api import refresh_params
from repro_torch.serve.engine import (ECON_COUNTERS, ECON_GAUGES, TEL_COUNTERS,
                                      TEL_GAUGES, ServeConfig, _tick_buckets,
                                      make_serve_engine)
from repro_torch.serve.stream import poisson_request_stream
from repro_torch.sharding.runtime import cells_group, destroy_cells_group
from repro_torch.specs.observation import make_spec, spec_dim
from repro_torch.telemetry.live import (LiveEmitter, NdjsonSink,
                                        TrainLiveEmitter)


class Entry(NamedTuple):
    """One registered entry point.  ``inplace`` maps each field the call
    updates in place, as a path into its arguments, to the same field in
    its outputs (``{"2.q_ids": "0.q_ids"}``); ``check(contract)`` adds the
    entry's own problems."""
    name: str
    build: Callable          # (device) -> Built, fresh each call
    inplace: tuple = ()      # ((arg path, out path), ...)
    hot: bool = False        # a tick or a training epoch
    host_loop: bool = False  # its loop runs on the host by design
    check: Optional[Callable] = None


# ---------------------------------------------------------------------------
# serve engine

# the fields the tick writes in place: its rings and its records, and
# the telemetry buffer when on
_RINGS = ("q_ids", "q_len")
_RECORDS = tuple(f"rec.{f}" for f in ("wait_ms", "service_ms", "art_ms",
                                      "served", "dropped", "violated",
                                      "action"))
_TEL = ("tel.hist", "tel.counts", "tel.snaps")


# the recorded call serves the first epoch of a 400 ms stream: 4 ticks
_EPOCH_MS = 200.0


def _state_fields(arg: int, fields: Sequence[str]) -> tuple:
    return tuple((f"{arg}.{f}", f"0.{f}") for f in fields)


def _serve_build(cfg: ServeConfig, device, *, n_cells: int = 4,
                 sharded: bool = False, live: bool = False) -> Built:
    """A serve engine at ``cfg`` and the arguments of one ``run_epoch``
    call, prepared as ``serve_stream`` prepares them."""
    dev = torch.device(device)
    k_fleet, k_stream, k_init, _ = rnd.split(rnd.PRNGKey(0, dev), 4)
    scenario = random_fleet(k_fleet, n_cells, n_max=cfg.n_max,
                            cells_per_edge=2)
    spec = make_spec(cfg.obs_spec, cfg.n_max)
    if cfg.economy is not None:
        policy = cost_greedy_policy(spec, cfg.economy, tick_ms=cfg.tick_ms)
    else:
        policy = heuristic_greedy_policy(spec)
    mesh = cells_group(dev) if sharded else None
    emitter = None
    if live:
        counters = TEL_COUNTERS + (ECON_COUNTERS if cfg.economy else ())
        gauges = TEL_GAUGES + (ECON_GAUGES if cfg.economy else ())
        emitter = LiveEmitter(NdjsonSink(io.StringIO()), counters, gauges,
                              window_ms=cfg.window_ms)
    engine = make_serve_engine(policy, cfg, live=emitter, mesh=mesh)
    stream = poisson_request_stream(k_stream, scenario, 400.0, rate=1.0,
                                    round_ms=cfg.round_ms,
                                    epoch_ms=_EPOCH_MS)
    ticks_per_epoch = max(1, int(round(stream.epoch_ms / cfg.tick_ms)))
    ids, now, live_ticks, _ = _tick_buckets(stream, cfg.tick_ms,
                                            ticks_per_epoch)
    n_windows = int((int(live_ticks.sum()) - 1)
                    * cfg.tick_ms // cfg.window_ms) + 1
    # with its group index, built once (as serve_stream builds it)
    scenario = (scenario.shard(0, 1) if sharded else scenario).to(dev)
    state = engine.init(k_init, scenario, stream.n_requests, n_windows)
    params = refresh_params(policy, policy.init(0, dev), scenario)
    # a policy builds its per-device tables at its first act, once a run
    # (serve_stream's first epoch pays it as set-up): pay it here, so the
    # recorded epoch is a steady one
    policy.act(params, torch.zeros((scenario.n_cells, spec.dim), device=dev),
               k_init)
    f32 = lambda x: torch.as_tensor(np.append(x, 0.0).astype(np.float32),
                                    device=dev)
    hi = ticks_per_epoch
    args = (params, scenario, state,
            torch.as_tensor(np.ascontiguousarray(ids[:hi, 0]), device=dev),
            now[:hi], live_ticks[:hi], f32(stream.t_ms),
            torch.as_tensor(np.append(stream.cell, 0).astype(np.int32),
                            device=dev),
            f32(stream.slo_ms))
    close = (lambda: destroy_cells_group(mesh)) if sharded else None
    return Built(engine.run_epoch, args, {}, close)


_SERVE_CFG = ServeConfig(n_max=3, obs_spec="base", queue_cap=8)
# the benchmark sweep's serving configuration: its all_reduce count is
# the tick's collective budget
_SERVE_SHARDED_CFG = ServeConfig(n_max=5, obs_spec="full", tick_ms=50.0,
                                 shared_cloud=True, shared_edge=True)
_SERVE_LIVE_CFG = ServeConfig(n_max=3, obs_spec="base", queue_cap=8,
                              telemetry=True, window_ms=100.0)
_SERVE_ECON_CFG = ServeConfig(n_max=3, obs_spec="full_economy",
                              queue_cap=8, telemetry=True,
                              economy=builtin_profile("spot"))
# two all_reduce a tick: the observation's and the transition's
ALL_REDUCE_PER_TICK = 2


def _check_all_reduce_budget(c: contracts.ProgramContract) -> list:
    """The sharded tick crosses ranks twice a tick, no more."""
    ticks = int(round(_EPOCH_MS / _SERVE_SHARDED_CFG.tick_ms))
    got = c.collectives.get("all_reduce", 0)
    if got > ALL_REDUCE_PER_TICK * ticks:
        return [f"[{c.name}] collectives: {got} all_reduce in an epoch of "
                f"{ticks} ticks, over the budget of {ALL_REDUCE_PER_TICK} "
                f"a tick"]
    return []


# ---------------------------------------------------------------------------
# hltrain

_HL_PARAMS = FleetHLParams(epochs=2, n_direct=1, t_direct=2, n_world=1,
                           n_suggest=1, t_suggest=2, n_plan=1, k_best=2,
                           batch=8, direct_cap=64, world_cap=64,
                           plan_cap=32, hidden=(8, 8))
_RING = ("s", "a", "r", "s2", "done")
_BUFFERS = (tuple(f"d_direct.ring.{f}" for f in _RING) + ("d_direct.prio",)
            + tuple(f"d_world.{f}" for f in _RING)
            + tuple(f"d_plan.buf.ring.{f}" for f in _RING)
            + ("d_plan.buf.prio", "d_plan.keys"))


def _hltrain_build(device, telemetry: bool = False,
                   live: bool = False) -> Built:
    hp = (dataclasses.replace(_HL_PARAMS, telemetry=True) if telemetry
          else _HL_PARAMS)
    emitter = TrainLiveEmitter(NdjsonSink(io.StringIO())) if live else None
    trainer = make_hl_trainer(FleetConfig(n_max=3, obs_spec="base"),
                              hp, live=emitter)
    key = rnd.PRNGKey(0, device)
    scenario = random_fleet(key, 4, n_max=3).with_group_index()
    state = trainer.init(key, scenario)
    return Built(trainer.run, (state, scenario, 0, 1), {})


# ---------------------------------------------------------------------------
# policy decision surfaces


def _oracle_build(device) -> Built:
    n_max, C = 3, 4
    spec = make_spec("base", n_max)
    policy = oracle_policy(spec)
    params = {"table": torch.zeros((C, n_max, n_max), dtype=torch.int32,
                                   device=device),
              "n_users": torch.full((C,), n_max, dtype=torch.int32,
                                    device=device)}
    obs = torch.zeros((C, spec_dim(spec)), device=device)
    return Built(policy.act, (params, obs, rnd.PRNGKey(0, device)), {})


def _cost_greedy_build(device) -> Built:
    n_max, C = 3, 4
    spec = make_spec("full_economy", n_max)
    policy = cost_greedy_policy(spec, builtin_profile("spot"), tick_ms=50.0)
    scenario = random_fleet(rnd.PRNGKey(0, device), C, n_max=n_max)
    params = policy.refresh(policy.init(1, device), scenario)
    obs = torch.zeros((C, spec_dim(spec)), device=device)
    return Built(policy.act, (params, obs, rnd.PRNGKey(2, device)), {})


# ---------------------------------------------------------------------------
# kernels


def _group_occupancy_build(device) -> Built:
    own = torch.ones(8, device=device)
    index = group_index(torch.zeros(8, dtype=torch.int32, device=device))
    return Built(group_occupancy, (own, index), {})


def _queue_admit_build(device) -> Built:
    C, Q, A = 4, 8, 3
    i32 = dict(dtype=torch.int32, device=device)
    return Built(queue_admit, (
        torch.full((C, Q), -1, **i32), torch.zeros(C, **i32),
        torch.zeros(C, **i32), torch.arange(A, **i32),
        torch.zeros(A, **i32), torch.ones(A, dtype=torch.bool,
                                          device=device)), {})


def _flash_attention_build(device) -> Built:
    B, S, H, D = 1, 16, 2, 8
    q, k, v = (torch.zeros((B, S, H, D), device=device) for _ in range(3))
    return Built(flash_attention, (q, k, v), {})


# ---------------------------------------------------------------------------
# economy


def _economy_build(device) -> Built:
    profile = builtin_profile("spot")
    C, n_max = 4, 3
    econ = init_economy(profile, C, n_max, device)
    z = torch.zeros(C, dtype=torch.int32, device=device)
    mask = torch.zeros((C, n_max), dtype=torch.bool, device=device)
    kwargs = dict(tick_ms=50.0, action=z, cursor=z,
                  active=torch.ones(C, dtype=torch.bool, device=device),
                  now=0.0, round_start=torch.zeros(C, device=device),
                  round_actions=torch.full((C, n_max), -1, dtype=torch.int32,
                                           device=device),
                  in_round=mask, rec_mask=mask,
                  times=torch.zeros((C, n_max), device=device),
                  fin=torch.zeros(C, dtype=torch.bool, device=device),
                  key=rnd.PRNGKey(0, device),
                  cell_ids=torch.arange(C, device=device))
    return Built(advance_economy, (profile, econ), kwargs)


_BILLING = ("spend_uusd", "energy_mj", "cold_starts", "preemptions")


def _check_billing_integer(c: contracts.ProgramContract) -> list:
    """Billing stays integer: the advanced state's µ$ / mJ ledgers and
    event counts (``TierEconomyState``) are int32, as the reference's (the
    audit compares them exactly; floats would drift).  The tick's µ$ / mJ
    events must be integers too; torch sums int32 into int64, which the
    telemetry window counts they add to are on purpose.  The dtypes do not
    depend on the device: the check runs on the CPU."""
    built = _economy_build("cpu")
    econ2, _pen, events = built.fn(*built.args, **built.kwargs)
    problems = []
    for field in _BILLING:
        dt = getattr(econ2, field).dtype
        if dt != torch.int32:
            problems.append(f"[{c.name}] billing: {field} must be int32 "
                            f"(integer billing), got {dt}")
    for name in ("spend_uusd", "energy_mj"):
        if events[name].dtype.is_floating_point:
            problems.append(f"[{c.name}] billing: event {name} must be an "
                            f"integer, got {events[name].dtype}")
    return problems


# ---------------------------------------------------------------------------
# the paper's single-cell agent

_SC_HP = HLHyperParams(batch=8, hidden=(8, 8), buffer_cap=64)


def _single_cell_build(device) -> Built:
    """An ``HLAgent`` at 3 users, A/89%, its D_direct and D_world filled
    with one batch of random-action transitions."""
    env = EdgeCloudEnv(EnvConfig(SCENARIOS["A"], CONSTRAINTS["89%"],
                                 n_users=3, seed=0))
    agent = HLAgent(env, _SC_HP, device=device)
    rng = np.random.default_rng(0)
    obs = env.reset()
    for _ in range(_SC_HP.batch):
        a = int(rng.integers(env.n_actions))
        obs2, r, done, _ = env.step(a)
        agent.d_direct.add(obs, a, r, obs2, done)
        agent.d_world.add(obs, a, r, obs2, done)
        obs = env.reset() if done else obs2

    def update():
        prioritized_update(agent, agent.d_direct)
        agent._system_model_session()

    return Built(update, (), {})


# ---------------------------------------------------------------------------
# the registry


ENTRIES = (
    Entry("serve_epoch", lambda d: _serve_build(_SERVE_CFG, d),
          inplace=_state_fields(2, _RINGS + _RECORDS), hot=True),
    Entry("serve_epoch_sharded",
          lambda d: _serve_build(_SERVE_SHARDED_CFG, d, sharded=True),
          inplace=_state_fields(2, _RINGS + _RECORDS), hot=True,
          check=_check_all_reduce_budget),
    Entry("serve_epoch_live",
          lambda d: _serve_build(_SERVE_LIVE_CFG, d, live=True),
          inplace=_state_fields(2, _RINGS + _RECORDS + _TEL), hot=True),
    Entry("serve_epoch_economy", lambda d: _serve_build(_SERVE_ECON_CFG, d),
          inplace=_state_fields(2, _RINGS + _RECORDS + _TEL), hot=True),
    Entry("hltrain_run", _hltrain_build,
          inplace=_state_fields(0, _BUFFERS), hot=True),
    Entry("hltrain_run_live",
          lambda d: _hltrain_build(d, telemetry=True, live=True),
          inplace=_state_fields(0, _BUFFERS + _TEL), hot=True),
    Entry("oracle_act", _oracle_build),
    Entry("cost_greedy_act", _cost_greedy_build),
    Entry("orch_group_occupancy", _group_occupancy_build),
    Entry("orch_queue_admit", _queue_admit_build,
          inplace=(("0", "0"), ("2", "1"))),
    Entry("flash_attention", _flash_attention_build),
    Entry("economy_advance", _economy_build, check=_check_billing_integer),
    Entry("single_cell_update", _single_cell_build, host_loop=True),
)


def trace_all(only: Optional[Sequence[str]] = None,
              entries: Sequence[Entry] = ENTRIES,
              device="cuda") -> dict:
    """Run every (selected) entry on ``device`` and record its contract.
    Unknown ``--only`` names raise: an assertion on a renamed entry must
    fail loudly."""
    if only is not None:
        known = {e.name for e in entries}
        unknown = sorted(set(only) - known)
        if unknown:
            raise KeyError(f"unknown registry entries {unknown}; "
                           f"known: {sorted(known)}")
        entries = [e for e in entries if e.name in set(only)]
    return {e.name: contracts.run_contract(
                e.name, lambda e=e: e.build(device), inplace=dict(e.inplace))
            for e in entries}


def run_check(current: dict, baseline: Optional[dict],
              entries: Sequence[Entry] = ENTRIES, *,
              partial: bool = False) -> list:
    """Policy checks, entry checks, the kernel sources' float64 scan and
    the baseline diff -> problem messages.  ``partial=True`` (an
    ``--only`` subset) diffs only the names run against their baseline
    records instead of requiring the full set."""
    by_name = {e.name: e for e in entries}
    problems = list(contracts.kernel_float64_problems())
    for name, c in current.items():
        e = by_name.get(name)
        problems.extend(contracts.contract_problems(
            c, hot=e is not None and e.hot,
            host_loop=e is not None and e.host_loop))
        if e is not None and e.check is not None:
            problems.extend(e.check(c))
    if baseline is not None:
        base = baseline
        if partial:
            base = {k: v for k, v in baseline.items() if k in current}
            missing = sorted(set(current) - set(baseline))
            if missing:
                problems.append(
                    f"entries {missing} are run but absent from the "
                    f"committed baseline -- run --update")
        problems.extend(contracts.diff_contracts(base, current))
    return problems
