"""Tier economics on tensors: price, energy and a startup state machine
per tier.

Counterpart of ``repro.economy.tiers``.  Every device tier (local, edge,
cloud) has a usage price ($ per request-second of service), an uptime
price ($ per second a tier instance is kept warm), an energy cost (J per
request) and a startup state machine

    COLD --route--> WARMING --cold_start_ticks--> WARM
    WARM --idle_timeout_ticks idle--> COLD          (scale-to-zero)
    WARM/WARMING --preempt_prob per tick--> WARMING (spot preemption,
                                                     recovery_ticks)

held per (cell, tier) in a :class:`TierEconomyState` of tensors, carried
on ``FleetState.econ`` and advanced once per serving tick by
:func:`advance_economy`.  A request routed to a tier that is not warm
waits out the remaining warmup; the engine adds that wait to its service
latency and its round's ART.

Billing is integer: spend in micro-dollars (µ$), energy in millijoules
(mJ), rounded once per cell and tick.  The float arithmetic before the
rounding is the reference's as its compiled tick evaluates it:
fixed-order sums, each division by a constant a product with the
constant's float32 reciprocal, the usage cost's terms fused into their
running sum and the holding cost added to it as fused multiply-adds
(emulated in float64, where the product of two float32 values is
exact).  The integers are therefore
the reference's bit for bit (``tests/test_torch_economy.py``), and the
same on the CPU and the card.

The preemption draws are ``uniform(fold_in(key, cell_id), (3,))`` per
global cell id, with the port's threefry: bit-equal to the reference's.
Everything stays on the device; nothing in a tick reads a value back to
the host.

Builtin profiles (:func:`builtin_profile`):

    ``local``       accounting only: every tier always warm and free,
                    energy still metered; schedules exactly as no
                    economy does
    ``serverless``  edge and cloud usage-priced, with two-tick cold
                    starts and scale-to-zero; no preemption
    ``spot``        a cheap uptime-priced edge with a slow cold start,
                    preemption and recovery, and scale-to-zero; the cloud
                    is the expensive always-available spill target
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.env import latency_model as lm

# startup states (per cell, per tier)
COLD, WARMING, WARM = 0, 1, 2
N_TIERS = 3
TIER_NAMES = ("local", "edge", "cloud")

SPEND_SCALE = 1e6   # µ$ per $
ENERGY_SCALE = 1e3  # mJ per J


@dataclasses.dataclass(frozen=True)
class EconomyProfile:
    """Static per-tier economics as 3-tuples ordered (local, edge, cloud).
    ``idle_timeout_ticks == 0`` disables scale-to-zero; ``preempt_prob``
    is per tick and needs ``recovery_ticks > 0`` to take effect."""
    name: str
    price_per_req_s: tuple    # $ per request-second of service
    uptime_price_per_s: tuple  # $ per second a tier is warm/warming
    energy_j_per_req: tuple   # J per served request
    cold_start_ticks: tuple   # ticks from COLD to WARM (0 = instant)
    preempt_prob: tuple       # per-tick P(preempt) while not cold
    recovery_ticks: tuple     # warmup after a preemption
    idle_timeout_ticks: tuple  # warm ticks with no traffic → COLD (0 = never)
    start_cold: tuple = (False, False, False)

    def __post_init__(self):
        """Every per-tier field is a 3-tuple of plain scalars: a profile
        is hashable, so its device tables are built once."""
        for f in dataclasses.fields(self):
            if f.name == "name":
                continue
            v = getattr(self, f.name)
            if not isinstance(v, tuple) or len(v) != N_TIERS:
                raise TypeError(
                    f"EconomyProfile.{f.name} must be a {N_TIERS}-tuple "
                    f"(local, edge, cloud), got {v!r}")
            if not all(isinstance(x, (int, float, bool)) for x in v):
                raise TypeError(
                    f"EconomyProfile.{f.name} entries must be plain "
                    f"int/float/bool scalars (hashable, jit-static), "
                    f"got {v!r}")

    def route_price(self) -> tuple:
        """Effective $/request-second a router weighs: usage price plus
        the uptime price the busy instance burns meanwhile."""
        return tuple(p + u for p, u in zip(self.price_per_req_s,
                                           self.uptime_price_per_s))


_BUILTIN = {
    "local": EconomyProfile(
        name="local",
        price_per_req_s=(0.0, 0.0, 0.0),
        uptime_price_per_s=(0.0, 0.0, 0.0),
        energy_j_per_req=(1.0, 4.0, 10.0),
        cold_start_ticks=(0, 0, 0),
        preempt_prob=(0.0, 0.0, 0.0),
        recovery_ticks=(0, 0, 0),
        idle_timeout_ticks=(0, 0, 0),
    ),
    "serverless": EconomyProfile(
        name="serverless",
        price_per_req_s=(0.0, 1.2e-3, 2.4e-3),
        uptime_price_per_s=(0.0, 0.0, 0.0),
        energy_j_per_req=(1.0, 4.0, 10.0),
        cold_start_ticks=(0, 2, 2),
        preempt_prob=(0.0, 0.0, 0.0),
        recovery_ticks=(0, 0, 0),
        idle_timeout_ticks=(0, 40, 40),
    ),
    "spot": EconomyProfile(
        name="spot",
        price_per_req_s=(0.0, 2.0e-4, 2.4e-3),
        uptime_price_per_s=(0.0, 2.0e-4, 0.0),
        energy_j_per_req=(1.0, 4.0, 10.0),
        cold_start_ticks=(0, 20, 0),
        preempt_prob=(0.0, 2.0e-3, 0.0),
        recovery_ticks=(0, 10, 0),
        idle_timeout_ticks=(0, 60, 20),
    ),
}
PROFILE_NAMES = tuple(_BUILTIN)


def builtin_profile(name: str) -> EconomyProfile:
    if name not in _BUILTIN:
        raise ValueError(f"unknown economy profile {name!r}; "
                         f"choose from {PROFILE_NAMES}")
    return _BUILTIN[name]


class TierEconomyState(NamedTuple):
    """Per-cell tier-economy state, every tensor leading (C, ...)."""
    tier_state: torch.Tensor       # (C, 3) int32 — COLD/WARMING/WARM
    warmup_left: torch.Tensor      # (C, 3) int32 — ticks until WARM
    idle_ticks: torch.Tensor       # (C, 3) int32 — consecutive idle ticks
    slot_penalty_ms: torch.Tensor  # (C, n_max) float32 — warmup wait per slot
    spend_uusd: torch.Tensor       # (C,) int32 — lifetime spend, µ$
    energy_mj: torch.Tensor        # (C,) int32 — lifetime energy, mJ
    cold_starts: torch.Tensor      # (C,) int32
    preemptions: torch.Tensor      # (C,) int32


@functools.lru_cache(maxsize=None)
def profile_tables(profile: EconomyProfile, device: torch.device) -> dict:
    """The profile's per-tier tuples as tensors on ``device``, built once
    per (profile, device), so a tick makes no host-to-device copy."""
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return {"cold_start": i32(profile.cold_start_ticks),
            "recovery": i32(profile.recovery_ticks),
            "idle_timeout": i32(profile.idle_timeout_ticks),
            "preempt_prob": f32(profile.preempt_prob),
            "price": f32(profile.price_per_req_s),
            "uptime_price": f32(profile.uptime_price_per_s),
            "energy": f32(profile.energy_j_per_req),
            "route_price": f32(profile.route_price()),
            "start": torch.where(torch.tensor(profile.start_cold,
                                              device=device),
                                 COLD, WARM).to(torch.int32),
            "draw": torch.arange(N_TIERS, dtype=torch.int64,
                                 device=device)}


def tier_of_action(a: torch.Tensor) -> torch.Tensor:
    """Action id → tier id (0 local, 1 edge, 2 cloud), int32; the
    undecided placeholder (-1) maps to local, as in the env."""
    return torch.where(a == lm.A_EDGE, 1,
                       torch.where(a == lm.A_CLOUD, 2, 0)).to(torch.int32)


def init_economy(profile: EconomyProfile, n_cells: int, n_max: int,
                 device="cuda") -> TierEconomyState:
    """Every tier warm (or cold where ``profile.start_cold`` says so),
    no penalty, nothing billed."""
    dev = torch.device(device)
    start = profile_tables(profile, dev)["start"]
    zi3 = torch.zeros((n_cells, N_TIERS), dtype=torch.int32, device=dev)
    zc = lambda: torch.zeros((n_cells,), dtype=torch.int32, device=dev)
    return TierEconomyState(
        tier_state=start[None, :].repeat(n_cells, 1),
        warmup_left=zi3, idle_ticks=zi3.clone(),
        slot_penalty_ms=torch.zeros((n_cells, n_max), dtype=torch.float32,
                                    device=dev),
        spend_uusd=zc(), energy_mj=zc(), cold_starts=zc(),
        preemptions=zc())


def ticks_to_warm(profile: EconomyProfile,
                  econ: TierEconomyState) -> torch.Tensor:
    """(C, 3) ticks until each tier could serve a request routed now: 0
    when warm, the remaining warmup when warming, the full cold start
    when cold."""
    cs = profile_tables(profile, econ.tier_state.device)["cold_start"]
    return torch.where(econ.tier_state == COLD, cs[None, :],
                       econ.warmup_left)


def fma32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as the fused multiply-add the
    reference's compiled code contracts it to (``b`` a float32 tensor or
    a constant, taken as float32): the product of two float32 values is
    exact in float64, and the float64 sum rounds to float32 as the fused
    form does (but for a float64 sum exactly halfway between two float32
    values, which no input of the tests has shown)."""
    b = b.double() if isinstance(b, torch.Tensor) else float(np.float32(b))
    return (a.double() * b + c.double()).float()


def _fma_row_sum(x: torch.Tensor, b: float) -> torch.Tensor:
    """``(x * b).sum(-1)`` as the reference's compiled reduction runs it:
    left to right, each term fused into the running sum,
    ``acc = fma(x[j], b, acc)``."""
    acc = torch.zeros_like(x[..., 0])
    for j in range(x.shape[-1]):
        acc = fma32(x[..., j], b, acc)
    return acc


def _gather(x: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """``x[cell, col[cell]]`` for every cell."""
    return x.gather(1, col.long()[:, None])[:, 0]


def _put(x: torch.Tensor, col: torch.Tensor, v: torch.Tensor):
    """``x`` with ``x[cell, col[cell]] = v[cell]``: one write a row, so
    the indices are unique."""
    return x.scatter(1, col.long()[:, None], v.to(x.dtype)[:, None])


def advance_economy(profile: EconomyProfile, econ: TierEconomyState, *,
                    tick_ms: float, action, cursor, active, now,
                    round_start, round_actions, in_round, rec_mask,
                    times, fin, key, cell_ids):
    """One serving tick of the tier state machine and its billing.

    ``action`` / ``cursor`` / ``active`` (C,) describe this tick's
    decisions; ``round_actions`` / ``in_round`` (C, n_max) the committed
    slots of in-flight rounds; ``rec_mask`` / ``times`` (C, n_max) and
    ``fin`` (C,) the rounds completing this tick; ``now`` the tick's
    clock (ms); ``key`` a threefry key; ``cell_ids`` (C,) the global cell
    ids that key the preemption draws.

    Returns ``(econ', slot_penalty_ms, events)``: the advanced state
    (slot penalties of finished rounds cleared), the penalty matrix
    before that clearing (what the engine adds to this tick's completed
    requests), and the tick's event sums as device scalars."""
    # imported here: the fleet env imports this module
    from repro_torch.fleet.latency import row_sum
    tab = profile_tables(profile, econ.tier_state.device)
    cs_ticks, rcv_ticks = tab["cold_start"], tab["recovery"]
    idle_to = tab["idle_timeout"]

    st, wl = econ.tier_state, econ.warmup_left
    tier = tier_of_action(action)
    sel = _gather(st, tier)
    cs_sel = cs_ticks[tier.long()]

    # -- decision: charge the chosen tier's remaining warmup to the slot,
    # measured from the round's start
    left_sel = torch.where(sel == COLD, cs_sel, _gather(wl, tier))
    pen_now = torch.where(active & (left_sel > 0),
                          (now - round_start)
                          + left_sel.to(torch.float32) * tick_ms, 0.0)
    slot_pen = _put(econ.slot_penalty_ms, cursor,
                    torch.where(active, pen_now,
                                _gather(econ.slot_penalty_ms, cursor)))
    # routing to a cold tier triggers its (single) cold start
    cold_hit = active & (sel == COLD)
    st = _put(st, tier, torch.where(
        cold_hit, torch.where(cs_sel > 0, WARMING, WARM), sel))
    wl = _put(wl, tier, torch.where(cold_hit, cs_sel, _gather(wl, tier)))
    cold_starts = cold_hit.to(torch.int32)

    # -- warmup countdown: a warming tier reaching zero turns warm
    warming = st == WARMING
    wl = torch.where(warming, (wl - 1).clamp(min=0), wl)
    st = torch.where(warming & (wl == 0), WARM, st).to(torch.int32)

    # -- scale-to-zero: a tier is busy iff a committed in-round slot runs
    # on it; enough consecutive idle ticks turn a warm tier cold
    slot_tier = tier_of_action(round_actions)
    decided = in_round & (round_actions >= 0)
    busy = torch.stack([(decided & (slot_tier == t)).any(-1)
                        for t in range(N_TIERS)], dim=-1)
    idle = torch.where(busy, 0, econ.idle_ticks + 1).to(torch.int32)
    timeout = ((st == WARM) & (idle_to[None, :] > 0)
               & (idle >= idle_to[None, :]))
    st = torch.where(timeout, COLD, st).to(torch.int32)
    idle = torch.where(timeout, 0, idle).to(torch.int32)

    # -- spot preemption: iid per (cell, tier), keyed by global cell id
    draw = rnd.uniform_at(rnd.fold_in(key, cell_ids)[:, None, :],
                          tab["draw"])
    pre = ((draw < tab["preempt_prob"][None, :]) & (st != COLD)
           & (rcv_ticks[None, :] > 0))
    wl = torch.where(pre, torch.maximum(wl, rcv_ticks[None, :]), wl)
    st = torch.where(pre, WARMING, st).to(torch.int32)
    preemptions = pre.sum(-1, dtype=torch.int32)

    # -- billing (integer µ$ / mJ, rounded once per cell and tick):
    # holding cost for every non-cold tier, usage and energy for the
    # requests completing this tick (their billed time includes the
    # warmup they waited out)
    hold = row_sum((st != COLD).to(torch.float32)
                   * tab["uptime_price"][None, :])
    billed_ms = torch.where(rec_mask, times + slot_pen, 0.0)
    use_usd = _fma_row_sum(billed_ms * tab["price"][slot_tier.long()],
                           1.0 / 1e3)
    use_j = row_sum(torch.where(rec_mask, tab["energy"][slot_tier.long()],
                                0.0))
    spend = torch.round(fma32(hold, tick_ms / 1e3, use_usd)
                        * SPEND_SCALE).to(torch.int32)
    joule = torch.round(use_j * ENERGY_SCALE).to(torch.int32)

    econ2 = TierEconomyState(
        tier_state=st, warmup_left=wl.to(torch.int32), idle_ticks=idle,
        slot_penalty_ms=torch.where(fin[:, None], 0.0, slot_pen),
        spend_uusd=econ.spend_uusd + spend,
        energy_mj=econ.energy_mj + joule,
        cold_starts=econ.cold_starts + cold_starts,
        preemptions=econ.preemptions + preemptions)
    events = {
        "cold_starts": cold_starts.sum(),
        "preemptions": preemptions.sum(),
        "spend_uusd": spend.sum(),
        "energy_mj": joule.sum(),
        "warm_tiers": (st == WARM).sum(),
        "warming_tiers": (st == WARMING).sum(),
    }
    return econ2, slot_pen, events
