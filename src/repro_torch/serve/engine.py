"""Event-driven request-level serving engine on one device.

Counterpart of ``repro.serve.engine`` (single device).  The engine
advances in decision ticks of ``tick_ms``; per tick it

    1. admits newly-arrived requests into fixed-capacity per-cell ring
       queues (``queue_admit`` kernel; overflow = counted drop),
    2. forms a round of ``min(queue_len, n_max)`` requests at every idle
       cell with backlog,
    3. micro-batches all pending decisions across cells through one
       ``Policy.act`` and advances the fleet env once
       (``FleetEnvFns.transition``: the env's next observation, which the
       tick would discard, is not computed), and
    4. scatters per-request records (wait, service, round ART, accuracy
       violation, action) for rounds that completed.

A tick launches the ``group_occupancy`` kernel at most three times, over
the scenario's group index (built once, at ``serve_stream``'s set-up):
in its ``observe``, for the edge coupling under ``shared_edge`` and for
the ``edge_load`` block of the ``contention`` and ``full`` specs, and
in the transition's edge coupling under ``shared_edge``.

It runs eagerly: ``serve_stream`` is a host loop over epochs and ticks.
The ring queues and the record arrays are updated in place (the
reference's functional scan copied them every tick); everything else is
rebuilt per tick.  Keys follow the reference's schedule exactly — one
split for the engine's init key, one for the env's, one per tick for the
policy and one per env step for the background — so with the same
scenario, stream, params and key the records equal the reference's.
Telemetry, the economy, live streaming and the cells mesh arrive with
later slices; asking for them raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.device import resolve_device, synchronize
from repro_torch.fleet.env import FleetConfig, FleetState, make_fleet_env
from repro_torch.fleet.workload import FleetScenario
from repro_torch.kernels.orchestration import queue_admit
from repro_torch.policy.api import (Policy, act_batch, params_to,
                                    refresh_params, require_device_side)
from repro_torch.serve.metrics import request_report
from repro_torch.serve.stream import RequestStream


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine configuration.  ``tick_ms`` is one decision tick's wall
    clock; a full round spans ``round_ms = n_max * tick_ms``.
    ``queue_cap`` bounds each cell's backlog; arrivals beyond it drop."""
    n_max: int = 5
    obs_spec: str = "base"
    tick_ms: float = 50.0
    queue_cap: int = 64
    quiet: bool = False
    shared_cloud: bool = False
    shared_edge: bool = False
    telemetry: bool = False
    economy: object = None

    def __post_init__(self):
        if self.telemetry:
            raise NotImplementedError("serving telemetry arrives with the "
                                      "port's telemetry slice")
        if self.economy is not None:
            raise NotImplementedError("tier economics arrive with the "
                                      "port's economy slice")

    @property
    def round_ms(self) -> float:
        return self.n_max * self.tick_ms

    def fleet(self) -> FleetConfig:
        return FleetConfig(n_max=self.n_max, obs_spec=self.obs_spec,
                           quiet=self.quiet,
                           shared_cloud=self.shared_cloud,
                           shared_edge=self.shared_edge)


class RequestRecords(NamedTuple):
    """Per-request outcome tensors of length N+1; slot N is the scatter
    sink of lanes that record nothing.  Updated in place."""
    wait_ms: torch.Tensor     # queueing delay: round start − arrival
    service_ms: torch.Tensor  # response time of this request's slot
    art_ms: torch.Tensor      # its round's ART
    served: torch.Tensor      # bool — round completed within the horizon
    dropped: torch.Tensor     # bool — rejected on queue overflow
    violated: torch.Tensor    # bool — its round violated the accuracy SLO
    action: torch.Tensor      # int32 — tier/model chosen (-1 until served)


class EngineState(NamedTuple):
    env: FleetState
    key: torch.Tensor
    q_ids: torch.Tensor        # (C, Q) int32 — queued request ids (ring)
    q_head: torch.Tensor       # (C,) int32
    q_len: torch.Tensor        # (C,) int32
    cur_n: torch.Tensor        # (C,) int32 — in-flight round size, 0 = idle
    cur_ids: torch.Tensor      # (C, n_max) int32 — ids in the round's slots
    round_start: torch.Tensor  # (C,) float32
    rec: RequestRecords


class ServeEngine(NamedTuple):
    """``init(key, scenario, n_requests)`` and ``run_epoch(params,
    scenario, state, tick_ids, tick_now, tick_live, stream_t,
    stream_cell) -> (state', n_decisions)``."""
    init: Callable
    run_epoch: Callable


def _reject_later_slices(live, mesh) -> None:
    if live is not None:
        raise NotImplementedError("live window streaming arrives with the "
                                  "port's telemetry slice")
    if mesh is not None:
        raise NotImplementedError("cells-mesh serving arrives with the "
                                  "port's sharded slice")


def make_serve_engine(policy: Policy, cfg: ServeConfig, live=None,
                      mesh=None) -> ServeEngine:
    _reject_later_slices(live, mesh)
    require_device_side(policy, "the request-level serving engine")
    env = make_fleet_env(cfg.fleet())
    n_max, Q = cfg.n_max, cfg.queue_cap

    def init(key, scenario: FleetScenario, n_requests: int) -> EngineState:
        C = scenario.n_cells
        dev = scenario.device
        k_env, key = rnd.split(key.to(dev))
        i32 = dict(dtype=torch.int32, device=dev)
        zf = lambda: torch.zeros(n_requests + 1, dtype=torch.float32,
                                 device=dev)
        zb = lambda: torch.zeros(n_requests + 1, dtype=torch.bool,
                                 device=dev)
        return EngineState(
            env=env.init(k_env, scenario), key=key,
            q_ids=torch.full((C, Q), -1, **i32),
            q_head=torch.zeros(C, **i32), q_len=torch.zeros(C, **i32),
            cur_n=torch.zeros(C, **i32),
            cur_ids=torch.full((C, n_max), -1, **i32),
            round_start=torch.zeros(C, dtype=torch.float32, device=dev),
            rec=RequestRecords(zf(), zf(), zf(), zb(), zb(), zb(),
                               torch.full((n_requests + 1,), -1, **i32)))

    def run_epoch(params, scenario: FleetScenario, state: EngineState,
                  tick_ids, tick_now, tick_live, stream_t, stream_cell):
        """Serve one epoch's ticks.  ``tick_ids`` (T_e, A) int32 device
        tensor of arriving request ids, -1-padded; ``tick_now`` (T_e,)
        float32 and ``tick_live`` (T_e,) bool host arrays (dead padding
        ticks are skipped); ``stream_t`` / ``stream_cell`` the (N+1,)
        per-request device arrays.  Returns the state and the number of
        real decisions (a device scalar)."""
        dev = scenario.device
        scratch = stream_t.shape[0] - 1
        slot = torch.arange(n_max, device=dev)
        params = refresh_params(policy, params, scenario)

        def live_tick(st: EngineState, ids, now: float):
            # -- 1. admit this tick's arrivals into the per-cell rings
            #       (q_ids and q_len in place) --
            valid = ids >= 0
            cell = stream_cell[ids.clamp(min=0)]
            q_ids, q_len, admitted = queue_admit(
                st.q_ids, st.q_head, st.q_len, ids, cell, valid)
            rec = st.rec
            rec.dropped[torch.where(valid & ~admitted, ids, scratch)] = True

            # -- 2. form rounds at idle cells with backlog --
            start = (st.cur_n == 0) & (q_len > 0)
            n_new = torch.where(start, q_len.clamp(max=n_max), 0)
            pos = (st.q_head[:, None] + slot[None, :]) % Q
            cand = q_ids.gather(1, pos.long())
            taken = slot[None, :] < n_new[:, None]
            cur_ids = torch.where(start[:, None],
                                  torch.where(taken, cand, -1), st.cur_ids)
            q_head = (st.q_head + n_new) % Q
            q_len.sub_(n_new)
            cur_n = torch.where(start, n_new, st.cur_n)
            round_start = torch.where(start, now, st.round_start)

            # -- 3. one fleet-wide micro-batched decision + env step --
            active = cur_n > 0
            n_eff = cur_n.clamp(min=1)
            scn_t = scenario._replace(n_users=n_eff)
            obs = env.observe(scn_t, st.env)
            key, k_act = rnd.split(st.key)
            a = act_batch(policy, params, obs, k_act, n_users=n_eff)
            # idle cells run a phantom 1-user round pinned to d0-local so
            # they add no edge/cloud occupancy under shared couplings;
            # their results are masked out of every record below
            a = torch.where(active, a, 0)
            env2, _, done, info = env.transition(scn_t, st.env, a)

            # -- 4. scatter per-request records of completed rounds --
            fin = done & active
            rec_mask = fin[:, None] & (slot[None, :] < cur_n[:, None])
            rid = torch.where(rec_mask, cur_ids, scratch)
            flat = rid.reshape(-1)
            spread = lambda v: v[:, None].expand(rid.shape).reshape(-1)
            rec.wait_ms[flat] = (round_start[:, None]
                                 - stream_t[rid]).reshape(-1)
            rec.service_ms[flat] = info["times"].reshape(-1)
            rec.art_ms[flat] = spread(info["art"])
            rec.served[flat] = True
            rec.violated[flat] = spread(info["violated"])
            rec.action[flat] = info["actions"].reshape(-1)

            st2 = EngineState(
                env=env2, key=key, q_ids=q_ids, q_head=q_head, q_len=q_len,
                cur_n=torch.where(fin, 0, cur_n), cur_ids=cur_ids,
                round_start=round_start, rec=rec)
            return st2, active.sum()

        n_decisions = torch.zeros((), dtype=torch.int64, device=dev)
        for ids, now, live in zip(tick_ids, tick_now, tick_live):
            if live:
                state, n = live_tick(state, ids, float(now))
                n_decisions += n
        return state, n_decisions

    return ServeEngine(init=init, run_epoch=run_epoch)


def _tick_buckets(stream: RequestStream, tick_ms: float,
                  ticks_per_epoch: int):
    """Host-side admission schedule: request ids bucketed by the first
    tick whose wall clock reaches their arrival, in arrival order within
    a tick.  Returns (T, A) -1-padded id rows (A = the largest burst), the
    (T,) tick times, the (T,) live-tick mask and the epoch count.  The
    ``ceil(horizon / tick) + 1`` live ticks cover every arrival before
    the horizon; T pads them to whole epochs with dead ticks."""
    n_ticks = max(1, int(np.ceil(stream.horizon_ms / tick_ms))) + 1
    n_epochs = -(-n_ticks // ticks_per_epoch)
    T = n_epochs * ticks_per_epoch
    tick_of = np.ceil(np.asarray(stream.t_ms, np.float64)
                      / tick_ms).astype(np.int64)
    idx = np.nonzero(tick_of < n_ticks)[0]
    counts = np.bincount(tick_of[idx], minlength=T)
    A = max(1, int(counts.max()))
    order = np.argsort(tick_of[idx], kind="stable")
    bucket = tick_of[idx][order]
    first = np.cumsum(counts) - counts
    ids = np.full((T, A), -1, np.int32)
    ids[bucket, np.arange(bucket.size) - first[bucket]] = idx[order]
    now = (np.arange(T, dtype=np.float64) * tick_ms).astype(np.float32)
    live = np.arange(T) < n_ticks
    return ids, now, live, n_epochs


def serve_stream(policy: Policy, params, scenario: FleetScenario,
                 stream: RequestStream, cfg: ServeConfig, *, key=None,
                 on_epoch: Optional[Callable] = None, verbose: bool = False,
                 device="cuda", live=None, mesh=None) -> dict:
    """Serve a :class:`RequestStream` end to end on ``device``.

    Returns ``repro_torch.serve.metrics.request_report`` plus engine
    timing and, under ``"records"``, the raw per-request numpy arrays.
    Epoch 0 (which includes building or loading the kernels) is timed as
    ``compile_time_s``; later epochs are the steady state
    (``run_time_s``, ``steady_ticks``, ``ms_per_tick``, host clock
    around work ended by a device synchronize).  ``key`` is a threefry
    key (default ``PRNGKey(0)``); ``on_epoch(epoch, params) -> params``
    runs at every epoch boundary (the bundle hot-swap point)."""
    _reject_later_slices(live, mesh)
    if scenario.n_cells != stream.n_cells:
        raise ValueError(f"stream built for {stream.n_cells} cells, "
                         f"scenario has {scenario.n_cells}")
    dev = resolve_device(device)
    scenario = scenario.to(dev)  # with its group index, built once here
    params = params_to(params, dev)
    key = rnd.PRNGKey(0, dev) if key is None else key.to(dev)
    engine = make_serve_engine(policy, cfg)
    ticks_per_epoch = max(1, int(round(stream.epoch_ms / cfg.tick_ms)))
    ids, now, live_ticks, n_epochs = _tick_buckets(stream, cfg.tick_ms,
                                                   ticks_per_epoch)
    N = stream.n_requests
    n_ticks = int(live_ticks.sum())
    ids = torch.as_tensor(ids, device=dev)
    stream_t = torch.as_tensor(np.append(stream.t_ms, 0.0).astype(np.float32),
                               device=dev)
    stream_cell = torch.as_tensor(
        np.append(stream.cell, 0).astype(np.int32), device=dev)

    k_init, key = rnd.split(key)
    state = engine.init(k_init, scenario, N)
    params_t = params
    wall, compile_wall, lanes, active, steady = 0.0, 0.0, 0, 0, 0
    for e in range(n_epochs):
        if on_epoch is not None:
            params_t = on_epoch(e, params_t)
        lo, hi = e * ticks_per_epoch, (e + 1) * ticks_per_epoch
        t0 = time.perf_counter()
        state, n_act = engine.run_epoch(
            params_t, scenario, state, ids[lo:hi], now[lo:hi],
            live_ticks[lo:hi], stream_t, stream_cell)
        synchronize(dev)
        dt = time.perf_counter() - t0
        if e > 0:
            wall += dt
            n_live = int(live_ticks[lo:hi].sum())
            steady += n_live
            lanes += scenario.n_cells * n_live
            active += int(n_act)
        else:
            compile_wall = dt
        if verbose:
            done = int(state.rec.served[:N].sum())
            print(f"  epoch {e:3d}: ticks [{lo}, {hi}), {done:6d}/{N} "
                  f"requests served, backlog {int(state.q_len.sum())}")

    records = {k: v[:N].cpu().numpy()
               for k, v in state.rec._asdict().items()}
    report = request_report(stream, records)
    report["device"] = str(dev)
    report["n_epochs"] = n_epochs
    report["n_ticks"] = n_ticks
    report["tick_ms"] = cfg.tick_ms
    report["compile_time_s"] = compile_wall
    report["run_time_s"] = wall
    report["steady_ticks"] = steady
    report["ms_per_tick"] = wall * 1e3 / steady if steady else None
    report["decisions_per_s"] = lanes / wall if lanes and wall > 0 else None
    report["active_decisions_per_s"] = (active / wall
                                        if active and wall > 0 else None)
    report["records"] = records
    return report
