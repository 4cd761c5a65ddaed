"""Exact optimizer for the quiet-background orchestration round (numpy).

Counterpart of ``repro.fleet.solver``, the same host-side numpy code:

  * The weak-node penalty (80 ms) is charged to every request of a weak
    node whatever its placement, so it is an additive constant and the
    rest of the assignment is symmetric in the users.
  * Edge and cloud costs depend only on the occupancy counts (k_edge,
    k_cloud), and both run d0, so their accuracy depends only on
    k_off = k_edge + k_cloud.
  * The n − k_off local users each pick one of 8 (time, accuracy) menu
    entries; the cheapest multiset above an accuracy floor is a dynamic
    program over the integer accuracy grid (Table III accuracies are
    exact tenths of a percent).

``solve_optimal`` is a function of its arguments alone — the first n
weak-node flags, the weak-edge flag, the constraint and n — so a fleet
holds few distinct calls (at most 2ⁿ · 2 · 5 per n at the Table-V
levels).  ``solve_cells`` calls it once per distinct argument tuple and
gathers the answers to the cells: the tables are the per-cell loop's,
bit for bit (``tests/test_torch_solver.py``), at a host cost of a few
hundred solver calls for any fleet size.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.env import latency_model as lm
from repro_torch.env.scenarios import Scenario

# Table III accuracies in integer tenths of a percent (exact).
_ACC_TENTHS = np.round(np.asarray(lm.ACCURACY) * 10).astype(np.int64)
_ACC_D0 = int(_ACC_TENTHS[0])  # edge/cloud both run d0


def _local_dp(n: int, t_menu=lm.T_LOCAL):
    """Exact DP over local-model multisets: f[u, a] is the least total
    local cost of u users whose accuracies sum to exactly a tenths (+inf
    where unreachable), choice[u, a] the model achieving it.  ``t_menu``
    is the per-model cost menu."""
    a_max = n * _ACC_TENTHS.max()
    f = np.full((n + 1, a_max + 1), np.inf)
    choice = np.zeros((n + 1, a_max + 1), np.int8)
    f[0, 0] = 0.0
    for u in range(1, n + 1):
        best = np.full(a_max + 1, np.inf)
        pick = np.zeros(a_max + 1, np.int8)
        for m in range(lm.N_MODELS):
            da = int(_ACC_TENTHS[m])
            cand = np.full(a_max + 1, np.inf)
            cand[da:] = f[u - 1, :a_max + 1 - da] + t_menu[m]
            better = cand < best
            best[better] = cand[better]
            pick[better] = m
        f[u] = best
        choice[u] = pick
    return f, choice


def _backtrack(choice, n_local: int, a: int) -> list[int]:
    models = []
    for u in range(n_local, 0, -1):
        m = int(choice[u, a])
        models.append(m)
        a -= int(_ACC_TENTHS[m])
    return models


def solve_optimal(scenario: Scenario, constraint: float, n_users: int, *,
                  tier_scale=(1.0, 1.0, 1.0),
                  tier_offset=(0.0, 0.0, 0.0)) -> dict:
    """The exact quiet-background optimum of one round: {"art", "acc",
    "actions", "objective"}, the actions in ascending order.

    ``tier_scale`` / ``tier_offset`` weight each (local, edge, cloud)
    tier's compute time as ``compute_ms·scale[t] + offset[t]``; the weak
    network penalties stay unscaled.  The defaults give the unweighted
    solver; ``art`` / ``acc`` always evaluate the chosen actions through
    the unweighted numpy model."""
    sc = scenario.for_users(n_users)
    n = n_users
    weak_e_edge = lm.WEAK_E_EDGE if sc.weak_e else 0.0
    weak_e_cloud = lm.WEAK_E_CLOUD if sc.weak_e else 0.0
    a0, a1, a2 = tier_scale
    b0, b1, b2 = tier_offset

    t_menu = [lm.T_LOCAL[m] * a0 + b0 for m in range(lm.N_MODELS)]
    f, choice = _local_dp(n, t_menu)
    # suffix minimum over the accuracy axis: g[u, a] = min_{a' >= a} f[u, a']
    g = np.minimum.accumulate(f[:, ::-1], axis=1)[:, ::-1]

    best = None
    for k_off in range(n + 1):
        n_local = n - k_off
        need = (constraint - 1e-9) * n * 10 - k_off * _ACC_D0
        a_req = max(0, math.ceil(need - 1e-6))
        if a_req > n_local * int(_ACC_TENTHS.max()):
            continue  # not enough local headroom at this split
        t_local = g[n_local, a_req] if n_local else 0.0
        if not np.isfinite(t_local):
            continue
        for k_e in range(k_off + 1):
            k_c = k_off - k_e
            t_off = (k_e * ((lm.T_EDGE_D0 * max(1, k_e)) * a1
                            + weak_e_edge + b1)
                     + k_c * ((lm.T_CLOUD_D0 * max(1, k_c)) * a2
                              + weak_e_cloud + b2))
            total = t_local + t_off
            if best is None or total < best[0] - 1e-12:
                best = (total, k_off, k_e, k_c, a_req)
    if best is None:
        raise ValueError(f"constraint {constraint} is unsatisfiable")

    objective, k_off, k_e, k_c, a_req = best
    n_local = n - k_off
    if n_local:
        row = f[n_local, a_req:]
        a_star = a_req + int(np.argmin(row))
        local_models = _backtrack(choice, n_local, a_star)
    else:
        local_models = []
    actions = np.array(sorted(local_models)
                       + [lm.A_EDGE] * k_e + [lm.A_CLOUD] * k_c,
                       dtype=np.int64)
    # report through the numpy model, as brute force evaluates a vector
    t = lm.response_times(actions, sc.weak_s_arr(), sc.weak_e)
    acc = lm.action_accuracy(actions)
    return {"art": float(t.mean()), "acc": float(acc.mean()),
            "actions": actions, "objective": float(objective)}


def host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def solve_cells(weak_s, weak_e, constraint, n_users) -> dict:
    """:func:`solve_optimal` for every row: weak_s (R, w) bool, weak_e
    (R,) bool, constraint (R,) float32, n_users (R,) ints in [1, w].
    Returns ``art`` / ``acc`` (R,) float64 and ``actions`` (R, w) int32
    (row r's optimal round in its first n_users[r] places, zeros after).

    Rows with equal arguments — the first n weak flags, the weak edge,
    the float32 constraint and n — share one solver call.  Each call
    takes the constraint snapped to the Table-V tenths grid,
    ``round(float(c), 4)``, as ``FleetScenario.cell`` does (89.9 is
    stored as 89.90000153 in float32)."""
    weak_s = host(weak_s).astype(bool)
    weak_e = host(weak_e).astype(bool)
    constraint = host(constraint).astype(np.float32)
    n_users = host(n_users).astype(np.int64)
    rows, width = weak_s.shape
    if width > 62:
        raise ValueError(f"solve_cells packs weak flags into 62 bits; "
                         f"got {width} slots")
    slots = np.arange(width)
    live = weak_s & (slots[None, :] < n_users[:, None])
    keys = np.stack([(live.astype(np.int64) << slots).sum(1),
                     weak_e.astype(np.int64),
                     constraint.view(np.int32).astype(np.int64),
                     n_users], axis=1)
    _, first, inverse = np.unique(keys, axis=0, return_index=True,
                                  return_inverse=True)
    art = np.empty(len(first))
    acc = np.empty(len(first))
    actions = np.zeros((len(first), width), np.int32)
    for j, i in enumerate(first):
        n = int(n_users[i])
        sc = Scenario(f"cell{i}", tuple(bool(x) for x in weak_s[i, :n]),
                      bool(weak_e[i]))
        r = solve_optimal(sc, round(float(constraint[i]), 4), n)
        art[j], acc[j] = r["art"], r["acc"]
        actions[j, :n] = r["actions"]
    inverse = inverse.reshape(-1)
    return {"art": art[inverse], "acc": acc[inverse],
            "actions": actions[inverse]}


def solve_fleet(scenario) -> dict:
    """Exact per-cell optima of a ``FleetScenario`` at its user counts:
    ``{"art", "acc"}`` of shape (C,), the reference's per-cell loop
    through :func:`solve_cells`.  Latency targets and edge groups are
    observation inputs only, so under the shared-cloud / shared-edge
    couplings the optimum is a per-cell lower bound."""
    out = solve_cells(scenario.weak_s, scenario.weak_e, scenario.constraint,
                      scenario.n_users)
    return {"art": out["art"], "acc": out["acc"]}
