"""Cost-aware routing: the cold-start-aware greedy policy and the exact
multi-objective solver.

Counterpart of ``repro.economy.routing``.  ``cost_greedy_policy``
extends the latency-greedy baseline with the observation's economy
block: among accuracy-feasible actions it minimizes

    effective_latency · (1 + λ_c · route_price[tier]) + λ_e · energy[tier]

where the effective latency adds the chosen tier's remaining warmup
(a cold tier charges its full cold start).  A tier that is not warm is
eligible only while its effective latency holds the cell's latency
target, and when the cheapest pick would miss that target the router
spills to the fastest feasible action, whatever its price.

``solve_optimal_economy`` maps the same scalarization onto the exact
solver's tier weights (usage cost is proportional to billed compute
time, energy is a per-request constant), on the host in numpy.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.economy.tiers import EconomyProfile, fma32
from repro_torch.env import latency_model as lm
from repro_torch.policy.adapters import (ACC_TOL, _require_base_first,
                                         _round_progress, _tables)
from repro_torch.policy.api import Policy
from repro_torch.specs.observation import (OCC_LEVELS, WARMUP_NORM,
                                           ObservationSpec)

# Default scalarization weights.  λ_c is in seconds of latency per
# dollar (1000: $1 weighs as 1000 s); λ_e is ms per joule (5: a 10 J
# cloud request adds 50 ms).
LAM_COST = 1000.0
LAM_ENERGY = 5.0


def cost_greedy_policy(spec: ObservationSpec, profile: EconomyProfile, *,
                       lam_cost: float = LAM_COST,
                       lam_energy: float = LAM_ENERGY,
                       tick_ms: float = 50.0) -> Policy:
    """Cold-start- and cost-aware greedy router over an economy spec.

    Decodes per-action latency estimates as ``heuristic_greedy_policy``
    does, then weighs them with the profile's routing prices and energy
    and the per-tier startup state of the ``economy`` block.  Params
    carry ``constraint``, ``n_users`` and ``latency_target`` (float32,
    per cell), re-derived by ``refresh``."""
    n_max = _require_base_first(spec)
    if not (isinstance(spec, ObservationSpec) and "economy" in spec.blocks):
        raise ValueError(
            "cost_greedy_policy needs a spec with the 'economy' block "
            "(variants 'economy' or 'full_economy'); got "
            f"{getattr(spec, 'name', spec)!r}")
    e0 = spec.block_slices()["economy"].start
    base = 4 * n_max
    tier_of = [0] * lm.N_MODELS + [1, 2]  # action → tier
    scale3 = [1.0 + lam_cost * p for p in profile.route_price()]
    energy3 = [lam_energy * e for e in profile.energy_j_per_req]

    @functools.lru_cache(maxsize=None)
    def weights(device):
        """Per-action tier index, cost scale and energy offset (float32,
        as the reference holds them), built once per device."""
        t = torch.tensor(tier_of, device=device)
        f32 = lambda v: torch.tensor(v, dtype=torch.float32,
                                     device=device)[t]
        return t, f32(scale3), f32(energy3)

    def act(params, obs, key):
        tab = _tables(obs.device)
        acc_menu = tab["acc_menu"]
        tier, scale, energy = weights(obs.device)
        n = params["n_users"].to(torch.float32)
        constraint = params["constraint"].to(torch.float32)
        target = params["latency_target"].to(torch.float32)
        u, committed, remaining = _round_progress(obs, n_max, n)
        busy_p = obs.gather(1, (n_max + u)[:, None])[:, 0] > 0.5
        busy_m = obs.gather(1, (2 * n_max + u)[:, None])[:, 0] > 0.5
        k_edge = obs[:, base] * OCC_LEVELS
        busy_m_e = obs[:, base + 1] > 0.5
        weak_e = obs[:, base + 2] > 0.5
        k_cloud = obs[:, base + 3] * OCC_LEVELS
        busy_m_c = obs[:, base + 4] > 0.5
        need = (constraint * n - committed) / remaining

        tl = (tab["t_local"][None, :]
              * torch.where(busy_p, lm.BUSY_CPU_LOCAL, 1.0)[:, None]
              * torch.where(busy_m, lm.BUSY_MEM, 1.0)[:, None])
        te = (lm.T_EDGE_D0 * (k_edge + 1.0).clamp(min=1.0)
              * torch.where(busy_m_e, lm.BUSY_MEM, 1.0)
              + torch.where(weak_e, lm.WEAK_E_EDGE, 0.0))
        tc = (lm.T_CLOUD_D0 * (k_cloud + 1.0).clamp(min=1.0)
              * torch.where(busy_m_c, lm.BUSY_MEM, 1.0)
              + torch.where(weak_e, lm.WEAK_E_CLOUD, 0.0))
        lat = torch.cat([tl, te[:, None], tc[:, None]], -1)

        # economy block: per tier [state/2, ticks-to-warm/norm, price/norm]
        eco = obs[:, e0:e0 + 9].reshape(-1, 3, 3)
        warm = eco[:, :, 0] > 0.75            # state feature 1.0 ⇔ WARM
        boot_ms = eco[:, :, 1] * WARMUP_NORM * tick_ms
        pen = torch.where(warm, 0.0, boot_ms)  # cold encodes its full start
        lat_eff = lat + pen[:, tier]

        feasible = (acc_menu[None, :] + ACC_TOL / remaining[:, None]
                    >= need[:, None])
        # deadline gating: a tier that is not warm is eligible only while
        # its warmup still fits the cell's latency target
        allowed = warm[:, tier] | (lat_eff <= target[:, None])
        # lat_eff · scale + energy rounded once, as the fused multiply-add
        # of the reference's compiled act (exact products in float64)
        w = fma32(lat_eff, scale[None, :], energy[None, :])
        cost = torch.where(feasible & allowed, w, torch.inf)
        # the fastest feasible action regardless of price
        spill = torch.where(feasible, lat_eff, torch.inf)
        # unsatisfiable remainder: the most accurate tier, cheapest
        fallback = torch.where(acc_menu[None, :] >= acc_menu.max() - 1e-6,
                               lat, torch.inf)
        a_cost = torch.argmin(cost, -1)
        a_fast = torch.argmin(spill, -1)
        # take the cheap pick only while it is predicted to hold the
        # cell's latency target, else spill to the fastest feasible
        cheap_ok = ((feasible & allowed).any(-1)
                    & (lat_eff.gather(1, a_cost[:, None])[:, 0] <= target))
        a = torch.where(cheap_ok, a_cost,
                        torch.where(feasible.any(-1), a_fast,
                                    torch.argmin(fallback, -1)))
        return a.to(torch.int32)

    def init(seed: int = 0, device="cuda"):
        dev = resolve_device(device)
        return {"constraint": torch.zeros(0, device=dev),
                "n_users": torch.zeros(0, device=dev),
                "latency_target": torch.zeros(0, device=dev)}

    def refresh(params, scenario):
        return {"constraint": scenario.constraint.to(torch.float32),
                "n_users": scenario.n_users.to(torch.float32),
                "latency_target": scenario.latency_targets()
                .to(torch.float32)}

    def with_users(params, n_users):
        return dict(params, n_users=n_users.to(torch.float32))

    return Policy("cost_greedy", init, act, refresh, with_users)


def economy_tier_weights(profile: EconomyProfile,
                         lam_cost: float = LAM_COST,
                         lam_energy: float = LAM_ENERGY):
    """(tier_scale, tier_offset) for ``fleet.solver.solve_optimal``: per
    request on tier t the scalarized objective adds
    ``compute_ms·(1 + λ_c·price_t) + λ_e·energy_t``."""
    scale = tuple(1.0 + lam_cost * p for p in profile.route_price())
    offset = tuple(lam_energy * e for e in profile.energy_j_per_req)
    return scale, offset


def solve_optimal_economy(scenario, constraint: float, n_users: int,
                          profile: EconomyProfile, *,
                          lam_cost: float = LAM_COST,
                          lam_energy: float = LAM_ENERGY) -> dict:
    """Exact optimum of the scalarized ``latency + λ_c·cost + λ_e·energy``
    round objective (quiet background); with λ_c = λ_e = 0 it is
    ``solve_optimal`` itself.  Returns the solver's dict plus the dollar
    cost (``cost_usd``) and energy (``energy_j``) of the chosen round."""
    from repro_torch.fleet.solver import solve_optimal
    scale, offset = economy_tier_weights(profile, lam_cost, lam_energy)
    r = solve_optimal(scenario, constraint, n_users,
                      tier_scale=scale, tier_offset=offset)
    sc = scenario.for_users(n_users)
    actions = np.asarray(r["actions"])
    t = lm.response_times(actions, sc.weak_s_arr(), sc.weak_e)
    tiers = np.where(actions == lm.A_EDGE, 1,
                     np.where(actions == lm.A_CLOUD, 2, 0))
    price = np.asarray(profile.route_price())
    energy = np.asarray(profile.energy_j_per_req)
    r["cost_usd"] = float((t / 1e3 * price[tiers]).sum())
    r["energy_j"] = float(energy[tiers].sum())
    return r
