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

With ``ServeConfig.economy`` set, step 3 is followed by one tick of the
tier economy (``repro_torch.economy.advance_economy``): cold starts and
preemptions add their warmup wait to the completed requests' service
latency and their round's ART, and µ$ / mJ accrue per cell on the
device; ``serve_stream`` reports the totals under ``"economy"``.

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
policy, one per tick for the preemption draws under an economy and one
per env step for the background — so with the same scenario, stream,
params and key the records equal the reference's.

With ``ServeConfig.telemetry`` on, a ``repro_torch.telemetry``
``MetricBuffer`` rides in the engine state: per-``window_ms`` counters
(admits, drops, served, violations, SLO attainment, decisions; and the
economy's cold starts, preemptions, µ$ and mJ), window-end gauges
(backlog, queue depth, in-flight requests, per-tier occupancy; warm and
warming tiers) and a log-spaced end-to-end latency histogram accumulate
on the device with no host sync in a tick; ``serve_stream`` reports
them under ``"telemetry"`` (``telemetry_report``).  A ``live`` emitter
(``repro_torch.telemetry.LiveEmitter``) gets each window on the tick
that closes it, with one device-to-host copy of that window's row, an
``epoch`` record at every epoch boundary and the run-end report once.
With telemetry off the tick runs the ops it ran before.

Under a cells group (``mesh=``, a ``repro_torch.sharding.CellsGroup``:
the reference's ``cells`` mesh) each rank serves its block of ``C / S``
cells (``FleetScenario.shard``): their queues, env and economy state, and
its own copies of the records and the telemetry buffer.  Only the
cross-cell couplings (one ``all_reduce`` in the observation and one in
the transition, ``fleet.latency.fleet_totals``) and the epoch's decision
count cross ranks.  At run end the ranks' copies are merged as the
reference merges its shards' (records: floats sum, flags any, actions
max; telemetry through ``merge_shard_buffers``; economy totals sum), so
every rank returns the report one device would: the same scenario,
stream, params and key give the same records for any group size, for
policies that act per cell (greedy, dqn, cost_greedy).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.device import resolve_device, synchronize
from repro_torch.economy.tiers import EconomyProfile, advance_economy
from repro_torch.fleet.env import FleetConfig, FleetState, make_fleet_env
from repro_torch.fleet.latency import A_CLOUD, A_EDGE, N_MODELS, row_sum
from repro_torch.fleet.workload import FleetScenario
from repro_torch.kernels.orchestration import queue_admit
from repro_torch.policy.api import (Policy, act_batch, params_to,
                                    refresh_params, require_device_side)
from repro_torch.serve.metrics import request_report
from repro_torch.serve.stream import RequestStream
from repro_torch.sharding.runtime import (CELLS_AXIS, COLLECTIVES, CellsGroup,
                                          all_gather_object, all_reduce,
                                          get_mesh_info)
from repro_torch.telemetry.live import host_lane
from repro_torch.telemetry.metrics import (MetricBuffer, buffer_series,
                                           count_events, merge_shard_buffers,
                                           metrics_init, observe_values,
                                           set_gauges, window_of)

# per-window counters and gauges of the engine's telemetry; counters add
# per tick, gauges keep the last (= window-end) snapshot
TEL_COUNTERS = ("admitted", "dropped", "served", "violated", "attained",
                "decisions")
TEL_GAUGES = ("backlog", "queue_depth", "inflight",
              "occ_local", "occ_edge", "occ_cloud")
# appended when ServeConfig.economy is set: the economy's events (µ$ and
# mJ as integers, so the audit's Σ window spend == run spend is exact)
# and its tier-state gauges
ECON_COUNTERS = ("cold_starts", "preemptions", "spend_uusd", "energy_mj")
ECON_GAUGES = ("warm_tiers", "warming_tiers")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine configuration.  ``tick_ms`` is one decision tick's wall
    clock; a full round spans ``round_ms = n_max * tick_ms``.
    ``queue_cap`` bounds each cell's backlog; arrivals beyond it drop.
    ``telemetry`` accumulates per-``window_ms`` metric series and a
    latency histogram on the device.  ``economy`` is an optional
    tier-economy profile (``repro_torch.economy.builtin_profile``)."""
    n_max: int = 5
    obs_spec: str = "base"
    tick_ms: float = 50.0
    queue_cap: int = 64
    quiet: bool = False
    shared_cloud: bool = False
    shared_edge: bool = False
    telemetry: bool = False
    window_ms: float = 1000.0
    economy: Optional[EconomyProfile] = None

    def __post_init__(self):
        if not (self.economy is None
                or isinstance(self.economy, EconomyProfile)):
            raise TypeError(f"ServeConfig.economy takes an EconomyProfile "
                            f"(builtin_profile(name)), got "
                            f"{self.economy!r}")

    @property
    def round_ms(self) -> float:
        return self.n_max * self.tick_ms

    def fleet(self, cells_group: Optional[CellsGroup] = None
              ) -> FleetConfig:
        return FleetConfig(n_max=self.n_max, obs_spec=self.obs_spec,
                           quiet=self.quiet,
                           shared_cloud=self.shared_cloud,
                           shared_edge=self.shared_edge,
                           economy=self.economy, cells_group=cells_group)


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
    tel: Optional[MetricBuffer] = None  # per-window metrics (None = off)


class ServeEngine(NamedTuple):
    """``init(key, scenario, n_requests, n_windows=1)`` and
    ``run_epoch(params, scenario, state, tick_ids, tick_now, tick_live,
    stream_t, stream_cell, stream_slo=None) -> (state', n_decisions)``."""
    init: Callable
    run_epoch: Callable


def _check_options(cfg: ServeConfig, live, mesh) -> None:
    if live is not None and not cfg.telemetry:
        raise ValueError("live streaming requires ServeConfig.telemetry "
                         "(the window series it exports)")
    if mesh is None:
        return
    if not isinstance(mesh, CellsGroup):
        raise TypeError(f"mesh takes a repro_torch.sharding.CellsGroup "
                        f"(cells_group(), or a rank of spawn_cells), got "
                        f"{mesh!r}")
    if live is not None:
        raise ValueError("live streaming is not supported under a cells "
                         "group — run the live serve single-device")


def make_serve_engine(policy: Policy, cfg: ServeConfig, live=None,
                      mesh=None) -> ServeEngine:
    """``live`` is an optional ``repro_torch.telemetry.LiveEmitter``
    (requires ``cfg.telemetry``): the tick that closes a telemetry window
    hands it that window's counters and gauges, one device-to-host copy
    a window.  ``mesh`` is a cells group (not with ``live``): ``init`` and
    ``run_epoch`` then take this rank's block of the scenario
    (``scenario.shard(rank, size)``), ``run_epoch`` its rows of arrivals
    and ``stream_cell`` as cell ids within the block."""
    _check_options(cfg, live, mesh)
    require_device_side(policy, "the request-level serving engine")
    env = make_fleet_env(cfg.fleet(mesh))
    n_max, Q = cfg.n_max, cfg.queue_cap
    # the economy's series ride in the same buffer when a profile is set
    counters = TEL_COUNTERS + (ECON_COUNTERS if cfg.economy else ())
    gauges = TEL_GAUGES + (ECON_GAUGES if cfg.economy else ())

    def init(key, scenario: FleetScenario, n_requests: int,
             n_windows: int = 1) -> EngineState:
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
                               torch.full((n_requests + 1,), -1, **i32)),
            tel=(metrics_init(n_windows, counters, gauges, device=dev)
                 if cfg.telemetry else None))

    def run_epoch(params, scenario: FleetScenario, state: EngineState,
                  tick_ids, tick_now, tick_live, stream_t, stream_cell,
                  stream_slo=None):
        """Serve one epoch's ticks.  ``tick_ids`` (T_e, A) int32 device
        tensor of arriving request ids, -1-padded; ``tick_now`` (T_e,)
        float32 and ``tick_live`` (T_e,) bool host arrays (dead padding
        ticks are skipped); ``stream_t`` / ``stream_cell`` / ``stream_slo``
        the (N+1,) per-request device arrays (``stream_slo`` is read by
        telemetry alone).  Returns the state and the number of real
        decisions (a device scalar, this rank's under a cells group)."""
        dev = scenario.device
        scratch = stream_t.shape[0] - 1
        slot = torch.arange(n_max, device=dev)
        # the global ids that key the economy's preemption draws
        cell0 = 0 if mesh is None else scenario.group_index.block.cell0
        cell_ids = cell0 + torch.arange(scenario.n_cells, device=dev)
        params = refresh_params(policy, params, scenario)

        def live_tick(st: EngineState, ids, now: np.float32):
            # -- 1. admit this tick's arrivals into the per-cell rings
            #       (q_ids and q_len in place) --
            valid = ids >= 0
            cell = stream_cell[ids.clamp(min=0)]
            q_ids, q_len, admitted = queue_admit(
                st.q_ids, st.q_head, st.q_len, ids, cell, valid)
            rec = st.rec
            rejected = valid & ~admitted
            # index_fill_ writes the constant on the device (a Python
            # True assigned by index would be a host tensor copied over:
            # a sync); masked lanes share the scratch slot, harmless
            # under one value
            rec.dropped.index_fill_(
                0, torch.where(rejected, ids, scratch).long(), True)

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
            round_start = torch.where(start, float(now), st.round_start)

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
            # the slots of this tick's active rounds (economy, telemetry)
            in_round = (active[:, None] & (slot[None, :] < cur_n[:, None])
                        if cfg.economy is not None or cfg.telemetry
                        else None)
            service, art = info["times"], info["art"]
            if cfg.economy is not None:
                # one tick of the tier economy: this tick's decisions may
                # start a cold tier (its wait charged to the slot), idle
                # tiers scale to zero, spot tiers preempt, µ$ / mJ accrue
                key, k_pre = rnd.split(key)
                econ2, pen, econ_ev = advance_economy(
                    cfg.economy, st.env.econ, tick_ms=cfg.tick_ms,
                    action=a, cursor=st.env.user.clamp(max=n_max - 1),
                    active=active, now=float(now), round_start=round_start,
                    round_actions=info["actions"], in_round=in_round,
                    rec_mask=rec_mask, times=info["times"], fin=fin,
                    key=k_pre, cell_ids=cell_ids)
                env2 = env2._replace(econ=econ2)
                # completed requests waited out their tier's warmup: the
                # wait lands in their service latency and the round's ART
                pen_rec = torch.where(rec_mask, pen, 0.0)
                service = service + pen_rec
                art = art + row_sum(pen_rec) / n_eff.to(torch.float32)
            rid = torch.where(rec_mask, cur_ids, scratch)
            flat = rid.reshape(-1)
            spread = lambda v: v[:, None].expand(rid.shape).reshape(-1)
            wait_lanes = round_start[:, None] - stream_t[rid]
            rec.wait_ms[flat] = wait_lanes.reshape(-1)
            rec.service_ms[flat] = service.reshape(-1)
            rec.art_ms[flat] = spread(art)
            rec.served.index_fill_(0, flat.long(), True)
            rec.violated[flat] = spread(info["violated"])
            rec.action[flat] = info["actions"].reshape(-1)
            n_decisions = active.sum()

            tel = st.tel
            if tel is not None:
                # -- 5. per-window device accumulators (no host sync) --
                w = window_of(tel, now, cfg.window_ms)
                e2e = wait_lanes + service
                attained = rec_mask & (e2e <= stream_slo[rid] + 1e-6)
                acts = info["actions"]
                # tiers count this tick's committed slots of active rounds
                decided = in_round & (acts >= 0)
                events = {
                    "admitted": admitted.sum(), "dropped": rejected.sum(),
                    "decisions": n_decisions, "served": rec_mask.sum(),
                    "violated": (rec_mask
                                 & info["violated"][:, None]).sum(),
                    "attained": attained.sum()}
                snaps = {
                    "backlog": q_len.sum(),
                    "queue_depth": q_len.to(torch.float32).mean(),
                    "inflight": torch.where(active, cur_n, 0).sum(),
                    "occ_local": (decided & (acts < N_MODELS)).sum(),
                    "occ_edge": (decided & (acts == A_EDGE)).sum(),
                    "occ_cloud": (decided
                                  & (acts == A_CLOUD)).sum()}
                if cfg.economy is not None:
                    # the integers the run totals add: the audit's
                    # conservation laws compare them exactly
                    events.update((n, econ_ev[n]) for n in ECON_COUNTERS)
                    snaps.update((n, econ_ev[n]) for n in ECON_GAUGES)
                count_events(tel, w, events)
                observe_values(tel, e2e, rec_mask)
                set_gauges(tel, w, snaps)
                # the window is closed (final) once the next tick falls
                # past it; serve_stream's finish() call flushes the last one
                if live is not None and window_of(
                        tel, now + np.float32(cfg.tick_ms),
                        cfg.window_ms) > w:
                    _emit_window(live, tel, w, now)

            st2 = EngineState(
                env=env2, key=key, q_ids=q_ids, q_head=q_head, q_len=q_len,
                cur_n=torch.where(fin, 0, cur_n), cur_ids=cur_ids,
                round_start=round_start, rec=rec, tel=tel)
            return st2, n_decisions

        n_decisions = torch.zeros((), dtype=torch.int64, device=dev)
        for ids, now, live_t in zip(tick_ids, tick_now, tick_live):
            if live_t:
                state, n = live_tick(state, ids, np.float32(now))
                n_decisions += n
        return state, n_decisions

    return ServeEngine(init=init, run_epoch=run_epoch)


@host_lane("on_window")
def _emit_window(live, tel: MetricBuffer, w: int, now: np.float32) -> None:
    """Hand window ``w``'s counters and gauges to ``live`` in one
    device-to-host copy: the gauges' float32 bits ride as int64 beside
    the counts."""
    K = len(tel.counter_names)
    row = torch.cat([tel.counts[w],
                     tel.snaps[w].view(torch.int32).to(torch.int64)])
    row = row.cpu().numpy()
    live.on_window(w, True, float(now), row[:K],
                   row[K:].astype(np.int32).view(np.float32))


def _tick_buckets(stream: RequestStream, tick_ms: float,
                  ticks_per_epoch: int, n_shards: int = 1):
    """Host-side admission schedule: request ids bucketed by the first
    tick whose wall clock reaches their arrival and by the shard that
    owns their cell (shard ``s`` holds cells ``[s·C/S, (s+1)·C/S)``), in
    arrival order within a bucket.  Returns (T, S, A) -1-padded id rows
    (A = the largest burst of a tick at a shard), the (T,) tick times,
    the (T,) live-tick mask and the epoch count.  The ``ceil(horizon /
    tick) + 1`` live ticks cover every arrival before the horizon; T pads
    them to whole epochs with dead ticks."""
    n_ticks = max(1, int(np.ceil(stream.horizon_ms / tick_ms))) + 1
    n_epochs = -(-n_ticks // ticks_per_epoch)
    T = n_epochs * ticks_per_epoch
    tick_of = np.ceil(np.asarray(stream.t_ms, np.float64)
                      / tick_ms).astype(np.int64)
    idx = np.nonzero(tick_of < n_ticks)[0]
    shard_of = (np.asarray(stream.cell, np.int64)[idx]
                // (stream.n_cells // n_shards))
    bucket = tick_of[idx] * n_shards + shard_of
    counts = np.bincount(bucket, minlength=T * n_shards)
    A = max(1, int(counts.max()))
    order = np.argsort(bucket, kind="stable")
    bucket = bucket[order]
    first = np.cumsum(counts) - counts
    ids = np.full((T * n_shards, A), -1, np.int32)
    ids[bucket, np.arange(bucket.size) - first[bucket]] = idx[order]
    now = (np.arange(T, dtype=np.float64) * tick_ms).astype(np.float32)
    live = np.arange(T) < n_ticks
    return ids.reshape(T, n_shards, A), now, live, n_epochs


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
    runs at every epoch boundary (the bundle hot-swap point).

    With ``cfg.telemetry`` the report carries ``"telemetry"``
    (``telemetry_report``).  ``live`` (a
    ``repro_torch.telemetry.LiveEmitter``, requires ``cfg.telemetry``)
    streams each closed window as the ticks run, gets an ``epoch`` record
    at every epoch boundary (one device-to-host copy) and is finished
    (final window, run summary) before this returns.

    ``mesh`` is a cells group (``repro_torch.sharding``); ``mesh=None``
    picks up the group a launcher registered (``set_mesh_info``), else
    serves on one device.  Under a group every rank calls this with the
    whole scenario and stream, serves its block on the rank's device
    (``device`` is not read) and returns the merged report; the cell
    count must divide over the group.  ``report["mesh_cells"]`` is the
    group size (1 on one device); under a group ``report["cells_group"]``
    holds the backend, this rank's collectives in the run and each
    rank's device and timing."""
    if mesh is None:
        info = get_mesh_info()
        mesh = None if info is None else info.group
    _check_options(cfg, live, mesh)
    if scenario.n_cells != stream.n_cells:
        raise ValueError(f"stream built for {stream.n_cells} cells, "
                         f"scenario has {scenario.n_cells}")
    S, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    if scenario.n_cells % S:
        raise ValueError(f"{scenario.n_cells} cells do not divide over the "
                         f"{S}-way {CELLS_AXIS!r} group")
    if mesh is None:
        dev = resolve_device(device)
        scenario = scenario.to(dev)  # with its group index, built once here
        cell0 = 0
    else:
        dev = mesh.device
        # this rank's block, with its group index, built once here
        scenario = scenario.shard(rank, S).to(dev)
        cell0 = scenario.group_index.block.cell0
    collectives0 = dict(COLLECTIVES)
    params = params_to(params, dev)
    key = rnd.PRNGKey(0, dev) if key is None else key.to(dev)
    engine = make_serve_engine(policy, cfg, live=live, mesh=mesh)
    ticks_per_epoch = max(1, int(round(stream.epoch_ms / cfg.tick_ms)))
    ids, now, live_ticks, n_epochs = _tick_buckets(
        stream, cfg.tick_ms, ticks_per_epoch, S)
    N = stream.n_requests
    n_ticks = int(live_ticks.sum())
    ids = torch.as_tensor(np.ascontiguousarray(ids[:, rank]), device=dev)
    stream_t = torch.as_tensor(np.append(stream.t_ms, 0.0).astype(np.float32),
                               device=dev)
    # each request's cell within this rank's block (its rows of ids hold
    # only the block's requests)
    stream_cell = torch.as_tensor(
        (np.append(stream.cell, 0) - cell0).astype(np.int32), device=dev)
    stream_slo = (torch.as_tensor(
        np.append(stream.slo_ms, 0.0).astype(np.float32), device=dev)
        if cfg.telemetry else None)

    # windows cover the live ticks: the last live tick's clock decides the
    # count, epoch padding never adds a window
    n_windows = int((n_ticks - 1) * cfg.tick_ms // cfg.window_ms) + 1
    k_init, key = rnd.split(key)
    state = engine.init(k_init, scenario, N, n_windows)
    params_t = params
    wall, compile_wall, lanes, active, steady = 0.0, 0.0, 0, 0, 0
    for e in range(n_epochs):
        if on_epoch is not None:
            params_t = on_epoch(e, params_t)
        lo, hi = e * ticks_per_epoch, (e + 1) * ticks_per_epoch
        t0 = time.perf_counter()
        state, n_act = engine.run_epoch(
            params_t, scenario, state, ids[lo:hi], now[lo:hi],
            live_ticks[lo:hi], stream_t, stream_cell, stream_slo)
        progress = None
        if mesh is not None:
            # the epoch's decisions and the progress line's figures summed
            # over the group (every rank sends the same shape, printing or
            # not): one collective an epoch
            total = all_reduce(torch.stack(
                [n_act] + _progress(state, N)).to(torch.int64), mesh)
            n_act, progress = total[0], list(total[1:])
        synchronize(dev)
        dt = time.perf_counter() - t0
        if e > 0:
            wall += dt
            n_live = int(live_ticks[lo:hi].sum())
            steady += n_live
            lanes += scenario.n_cells * S * n_live
            active += int(n_act)
        else:
            compile_wall = dt
        if verbose or live is not None:
            done, backlog, dropped = torch.stack(
                progress or _progress(state, N)).tolist()
            if live is not None:
                live.epoch(e, ticks=hi - lo, served=done, n_requests=N,
                           backlog=backlog, dropped=dropped,
                           wall_s=round(dt, 4))
            if verbose and rank == 0:
                print(f"  epoch {e:3d}: ticks [{lo}, {hi}), {done:6d}/{N} "
                      f"requests served, backlog {backlog}")

    records = {k: v[:N].cpu().numpy()
               for k, v in state.rec._asdict().items()}
    econ = None
    if cfg.economy is not None:
        # lifetime per-cell integer totals (µ$ / mJ) summed over the fleet
        e_st = state.env.econ
        econ = {k: int(getattr(e_st, k).sum(dtype=torch.int64))
                for k in ("spend_uusd", "energy_mj", "cold_starts",
                          "preemptions")}
    tel = state.tel
    group_info = None
    if mesh is not None:
        if tel is not None:
            tel = tel._replace(edges=tel.edges.cpu(), hist=tel.hist.cpu(),
                               counts=tel.counts.cpu(), snaps=tel.snaps.cpu())
        timing = dict(rank=rank, device=str(dev), compile_time_s=compile_wall,
                      run_time_s=wall,
                      ms_per_tick=wall * 1e3 / steady if steady else None)
        shards = all_gather_object(
            dict(records=records, econ=econ, tel=tel, timing=timing), mesh)
        records, econ, tel = _merge_shards(shards)
        group_info = dict(
            backend=mesh.backend, size=S,
            collectives={k: COLLECTIVES[k] - collectives0[k]
                         for k in COLLECTIVES},
            ranks=[sh["timing"] for sh in shards])
    report = request_report(stream, records)
    report["device"] = str(dev)
    report["mesh_cells"] = S
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
    if group_info is not None:
        report["cells_group"] = group_info
    if econ is not None:
        spend_uusd, energy_mj = econ["spend_uusd"], econ["energy_mj"]
        n_served = int(report["served_requests"])
        report["economy"] = {
            "profile": cfg.economy.name,
            "spend_uusd_total": spend_uusd,
            "cost_usd_total": spend_uusd / 1e6,
            "energy_j_total": energy_mj / 1e3,
            "cold_starts": econ["cold_starts"],
            "preemptions": econ["preemptions"],
            "cost_per_1k_requests": (spend_uusd / 1e3 / n_served
                                     if n_served else None),
            "joules_per_request": (energy_mj / 1e3 / n_served
                                   if n_served else None),
        }
    if cfg.telemetry:
        report["telemetry"] = telemetry_report(tel, cfg.window_ms)
        if live is not None:
            live.finish(report["telemetry"])
    return report


def _progress(state: EngineState, n: int) -> list:
    """An epoch line's figures on the device: requests served, the
    backlog, requests dropped."""
    return [state.rec.served[:n].sum(), state.q_len.sum(),
            state.rec.dropped[:n].sum()]


def _merge_shards(shards: list) -> tuple:
    """The ranks' record copies, economy totals and telemetry buffers as
    one device's: each request has one writer (its cell's rank), so
    floats sum over the zero-initialised copies, flags or together and
    actions (init -1) take the max; integer totals sum; telemetry merges
    through ``merge_shard_buffers`` (counters and histogram sum, gauges
    sum but ``queue_depth``, a mean over cells, which averages)."""
    def merge(name, copies):
        v = np.stack(copies)
        if v.dtype == np.bool_:
            return v.any(axis=0)
        return v.max(axis=0) if name == "action" else v.sum(axis=0)

    records = {k: merge(k, [sh["records"][k] for sh in shards])
               for k in shards[0]["records"]}
    econ = None
    if shards[0]["econ"] is not None:
        econ = {k: sum(sh["econ"][k] for sh in shards)
                for k in shards[0]["econ"]}
    tel = None
    if shards[0]["tel"] is not None:
        bufs = [sh["tel"] for sh in shards]
        tel = merge_shard_buffers(
            bufs[0]._replace(hist=torch.stack([b.hist for b in bufs]),
                             counts=torch.stack([b.counts for b in bufs]),
                             snaps=torch.stack([b.snaps for b in bufs])),
            gauge_reduce={"queue_depth": "mean"})
    return records, econ, tel


def telemetry_report(tel: MetricBuffer, window_ms: float) -> dict:
    """The engine's metric buffer on the host, JSON-safe: per-window
    series (counts, window-end gauges with None where unwritten, derived
    attainment) and the latency histogram with its p50/p95/p99."""
    s = buffer_series(tel)
    served = s["counters"]["served"].astype(np.float64)
    attained = s["counters"]["attained"].astype(np.float64)
    attainment = [None if n == 0 else float(a / n)
                  for a, n in zip(attained, served)]
    series = {n: v.tolist() for n, v in s["counters"].items()}
    series.update({n: [None if np.isnan(x) else float(x) for x in v]
                   for n, v in s["gauges"].items()})
    series["attainment"] = attainment
    return {
        "window_ms": window_ms,
        "n_windows": tel.n_windows,
        "series": series,
        "latency_hist": s["hist"].tolist(),
        "latency_hist_edges_ms": np.round(s["edges"], 4).tolist(),
        "hist_p50_latency_ms": s["hist_percentiles"]["p50"],
        "hist_p95_latency_ms": s["hist_percentiles"]["p95"],
        "hist_p99_latency_ms": s["hist_percentiles"]["p99"],
    }
