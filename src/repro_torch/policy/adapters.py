"""Policy adapters on tensors.

    dqn_policy               greedy argmax over the MLP's Q-values
    qtable_policy            the tabular Q baseline: params are the
                             table, keyed by the quantized observation
                             (host-side)
    heuristic_greedy_policy  parameter-free latency-greedy baseline: the
                             cheapest action whose accuracy keeps the
                             round's constraint satisfiable
    oracle_policy            the exact solver optimum as a policy: a
                             per-(cell, n) action table on the device,
                             looked up by the round cursor
    epsilon_greedy           exploration over any policy, from its key
    slo_guarded              feasibility guard: serves the wrapped
                             policy's pick unless it would make the
                             round's accuracy constraint unsatisfiable,
                             then the fallback (default: greedy) serves

Counterparts of ``repro.policy.adapters`` with the same arithmetic in
float32 and the same key schedule (actions test-enforced identical).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.core.networks import MLP
from repro_torch.device import resolve_device
from repro_torch.env import latency_model as lm
from repro_torch.policy.api import Policy
from repro_torch.specs.observation import (ACC_NORM, OCC_LEVELS,
                                           ObservationSpec, spec_dim)

# Feasibility slack (accuracy %), applied as ACC_TOL / remaining_users:
# ≥25x above the f32 decode noise of the committed-accuracy feature and
# 10x below the 0.1 % granularity of accuracies and constraint levels.
ACC_TOL = 1e-2


def _require_base_first(spec) -> int:
    """The greedy and guard adapters decode the round cursor and context
    from the ``base`` block, which every variant places first."""
    if isinstance(spec, ObservationSpec):
        if spec.blocks[0] != "base":
            raise ValueError(f"spec {spec.name!r} does not start with the "
                             f"base block")
        return spec.n_max
    return int(spec)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> dict:
    """Per-action accuracy (8 local tiers, then edge and cloud, which run
    d0) and local times, float32 on ``device``."""
    acc = np.concatenate([lm.ACCURACY, [lm.ACCURACY[0], lm.ACCURACY[0]]])
    return {"acc_menu": torch.as_tensor(acc, dtype=torch.float32,
                                        device=device),
            "t_local": torch.as_tensor(lm.T_LOCAL, dtype=torch.float32,
                                       device=device)}


def _round_progress(obs, n_max: int, n):
    """(cursor, committed accuracy sum, remaining users incl. the
    cursor's) decoded from the base block."""
    u = torch.argmax(obs[:, :n_max], -1)
    committed = obs[:, 4 * n_max + 6] * ACC_NORM * n
    remaining = (n - u).clamp(min=1.0)
    return u, committed, remaining


# --------------------------------------------------------------------- dqn
def dqn_policy(spec, n_actions: int = lm.N_ACTIONS,
               hidden=(128, 128)) -> Policy:
    """Greedy argmax over MLP Q-values; params is a
    :class:`~repro_torch.core.networks.MLP`."""
    dim = spec_dim(spec)

    def init(seed: int = 0, device="cuda"):
        return MLP((dim, *hidden, n_actions), seed).to(resolve_device(device))

    def act(params, obs, key):
        with torch.no_grad():
            return torch.argmax(params(obs), -1).to(torch.int32)

    return Policy("dqn", init, act)


def epsilon_greedy(policy: Policy, n_actions: int, epsilon: float
                   ) -> Policy:
    """With probability ``epsilon`` act uniformly at random, else as
    ``policy``: ``k_u, k_r, k_p = split(key, 3)``, the base policy acts on
    ``k_p``, ``randint(k_r)`` draws the random action and ``uniform(k_u)
    < epsilon`` picks, as the reference draws them.  A host-side base
    stays host-side."""

    def act(params, obs, key):
        k_u, k_r, k_p = rnd.split(key, 3)
        greedy = policy.act(params, obs, k_p)
        rand = rnd.randint(k_r, tuple(greedy.shape), 0, n_actions)
        explore = rnd.uniform(k_u, tuple(greedy.shape)) < epsilon
        return torch.where(explore, rand, greedy.to(torch.int32))

    return Policy(f"eps-{policy.kind}", policy.init, act, policy.refresh,
                  policy.with_users, host_side=policy.host_side)


# ------------------------------------------------------------------ qtable
def obs_table_key(obs, decimals: int = 4) -> bytes:
    """The tabular baseline's key of one observation row: rounded to
    ``decimals`` in float64, then its float32 bytes (the reference's
    bytes for the same float32 row)."""
    if isinstance(obs, torch.Tensor):
        obs = obs.detach().cpu().numpy()
    return np.round(np.asarray(obs, np.float64), decimals) \
        .astype(np.float32).tobytes()


def qtable_policy(n_actions: int = lm.N_ACTIONS) -> Policy:
    """Tabular Q baseline: ``params`` is the ``{obs_key: (n_actions,) q}``
    dict itself, so ``act`` runs on the host, row by row (``host_side``).
    Unseen states take action 0 (d0 local, most accurate), the argmax of
    a fresh row of zeros.  Actions come back on the observations'
    device."""

    def init(seed: int = 0, device="cuda"):
        return {}

    def act(params, obs, key):
        rows = obs.detach().cpu().numpy()
        out = np.zeros(rows.shape[0], np.int32)
        for i, row in enumerate(rows):
            q = params.get(obs_table_key(row))
            out[i] = 0 if q is None else int(np.argmax(np.asarray(q)))
        return torch.as_tensor(out, device=obs.device)

    return Policy("qtable", init, act, host_side=True)


# ---------------------------------------------------------------- heuristic
def heuristic_greedy_policy(spec) -> Policy:
    """Latency-greedy under the accuracy constraint, from the observation
    alone: the cheapest action whose accuracy is at least the average the
    remaining users must commit (so a satisfiable round stays feasible).
    Params carry ``constraint`` and ``n_users`` (float32, per cell)."""
    n_max = _require_base_first(spec)
    base = 4 * n_max

    def act(params, obs, key):
        tab = _tables(obs.device)
        acc_menu = tab["acc_menu"]
        n = params["n_users"].to(torch.float32)
        constraint = params["constraint"].to(torch.float32)
        u, committed, remaining = _round_progress(obs, n_max, n)
        busy_p = obs.gather(1, (n_max + u)[:, None])[:, 0] > 0.5
        busy_m = obs.gather(1, (2 * n_max + u)[:, None])[:, 0] > 0.5
        k_edge = obs[:, base] * OCC_LEVELS
        busy_m_e = obs[:, base + 1] > 0.5
        weak_e = obs[:, base + 2] > 0.5
        k_cloud = obs[:, base + 3] * OCC_LEVELS
        busy_m_c = obs[:, base + 4] > 0.5
        need = (constraint * n - committed) / remaining

        # per-action latency estimate for this user (the weak-link
        # penalty is placement-independent, so it cancels in the argmin)
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

        feasible = (acc_menu[None, :] + ACC_TOL / remaining[:, None]
                    >= need[:, None])
        cost = torch.where(feasible, lat, torch.inf)
        # unsatisfiable remainder (only from a foreign mid-round state):
        # the most accurate tier, cheapest
        top = acc_menu[None, :] >= acc_menu.max() - 1e-6
        fallback = torch.where(top, lat, torch.inf)
        a = torch.where(feasible.any(-1), torch.argmin(cost, -1),
                        torch.argmin(fallback, -1))
        return a.to(torch.int32)

    def init(seed: int = 0, device="cuda"):
        dev = resolve_device(device)
        return {"constraint": torch.zeros(0, device=dev),
                "n_users": torch.zeros(0, device=dev)}

    def refresh(params, scenario):
        return {"constraint": scenario.constraint.to(torch.float32),
                "n_users": scenario.n_users.to(torch.float32)}

    def with_users(params, n_users):
        return dict(params, n_users=n_users.to(torch.float32))

    return Policy("greedy", init, act, refresh, with_users)


# ------------------------------------------------------------------ oracle
def solve_oracle(scenario) -> dict:
    """Exact optima for every user count a round trace can ask of each
    cell: ``actions`` (C, n_max, n_max) int32 (row [c, n-1] is the
    optimal n-user round, zero-padded), ``art`` / ``acc`` (C, n_max)
    float64.  Host-side numpy (``fleet.solver.solve_cells``, one solver
    call per distinct argument tuple); compute once per fleet and reuse
    across rounds."""
    from repro_torch.fleet.solver import host, solve_cells
    n_cells, n_max = scenario.n_cells, scenario.n_max
    n = np.tile(np.arange(1, n_max + 1), n_cells)
    out = solve_cells(np.repeat(host(scenario.weak_s), n_max, axis=0),
                      np.repeat(host(scenario.weak_e), n_max),
                      np.repeat(host(scenario.constraint), n_max), n)
    return {"actions": out["actions"].reshape(n_cells, n_max, n_max),
            "art": out["art"].reshape(n_cells, n_max),
            "acc": out["acc"].reshape(n_cells, n_max)}


def oracle_params(scenario, tables: dict | None = None) -> dict:
    """Params for :func:`oracle_policy` on the scenario's device; pass
    precomputed :func:`solve_oracle` tables when replaying many
    rounds."""
    tables = solve_oracle(scenario) if tables is None else tables
    return {"table": torch.as_tensor(np.asarray(tables["actions"]),
                                     dtype=torch.int32,
                                     device=scenario.device),
            "n_users": scenario.n_users.to(torch.int32)}


def oracle_policy(spec) -> Policy:
    """The exact solver optimum as a policy: ``act`` gathers the table at
    (cell, n_users - 1, cursor), the cursor decoded from the base block —
    a gather on the device, with no host sync.  The optimum is
    quiet-background and per-cell, so it is a lower bound under
    background noise and the shared couplings; the order of actions
    within a round is immaterial (round metrics depend on the
    multiset)."""
    n_max = _require_base_first(spec)

    def act(params, obs, key):
        n = params["n_users"].long()
        cell = torch.arange(obs.shape[0], device=obs.device)
        u = torch.argmax(obs[:, :n_max], -1)
        return params["table"][cell, (n - 1).clamp(min=0),
                               torch.minimum(u, n - 1)].to(torch.int32)

    def init(seed: int = 0, device="cuda"):
        dev = resolve_device(device)
        return {"table": torch.zeros((0, n_max, n_max), dtype=torch.int32,
                                     device=dev),
                "n_users": torch.zeros(0, dtype=torch.int32, device=dev)}

    def refresh(params, scenario):
        return dict(params, n_users=scenario.n_users.to(torch.int32))

    def with_users(params, n_users):
        return dict(params, n_users=n_users.to(torch.int32))

    return Policy("oracle", init, act, refresh, with_users)


# ----------------------------------------------------------------- guarded
def slo_guarded_params(inner_params, fallback_params, device="cuda") -> dict:
    """Params for :func:`slo_guarded` around already-built inner params;
    the scenario-borne fields stay empty until ``refresh`` or
    ``with_users`` binds them."""
    dev = resolve_device(device)
    return {"inner": inner_params, "fallback": fallback_params,
            "constraint": torch.zeros(0, device=dev),
            "n_users": torch.zeros(0, device=dev)}


def slo_guarded(policy: Policy, spec, fallback: Policy | None = None
                ) -> Policy:
    """Serve ``policy``'s pick unless, after committing its accuracy,
    even every remaining user at the most accurate tier cannot reach the
    round's constraint; then ``fallback`` (default: the greedy
    heuristic) serves.  The prediction is exact under the env's
    accuracy accounting, so the guarded policy never violates a
    satisfiable constraint.  Params: ``{"inner", "fallback",
    "constraint", "n_users"}`` (see :func:`slo_guarded_params`)."""
    fallback = heuristic_greedy_policy(spec) if fallback is None else fallback
    n_max = _require_base_first(spec)
    acc_max = float(lm.ACCURACY.max())

    def act(params, obs, key):
        keys = rnd.split(key)
        a_in = policy.act(params["inner"], obs, keys[0])
        a_fb = fallback.act(params["fallback"], obs, keys[1])
        n = params["n_users"].to(torch.float32)
        constraint = params["constraint"].to(torch.float32)
        _, committed, remaining = _round_progress(obs, n_max, n)
        # best reachable round accuracy sum if a_in is committed now and
        # every later user picks the most accurate tier
        best = (committed + _tables(obs.device)["acc_menu"][a_in]
                + (remaining - 1.0) * acc_max)
        ok = best + ACC_TOL >= constraint * n
        return torch.where(ok, a_in, a_fb).to(torch.int32)

    def init(seed: int = 0, device="cuda"):
        return slo_guarded_params(policy.init(seed, device),
                                  fallback.init(seed + 1, device), device)

    def refresh(params, scenario):
        inner = params["inner"]
        if policy.refresh is not None:
            inner = policy.refresh(inner, scenario)
        fb = params["fallback"]
        if fallback.refresh is not None:
            fb = fallback.refresh(fb, scenario)
        return {"inner": inner, "fallback": fb,
                "constraint": scenario.constraint.to(torch.float32),
                "n_users": scenario.n_users.to(torch.float32)}

    def with_users(params, n_users):
        inner = params["inner"]
        if policy.with_users is not None:
            inner = policy.with_users(inner, n_users)
        fb = params["fallback"]
        if fallback.with_users is not None:
            fb = fallback.with_users(fb, n_users)
        return dict(params, inner=inner, fallback=fb,
                    n_users=n_users.to(torch.float32))

    return Policy(f"guarded-{policy.kind}", init, act, refresh, with_users,
                  host_side=policy.host_side or fallback.host_side)
