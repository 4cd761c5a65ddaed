"""Fleet scenarios: the stacked, padded description of C cells.

Counterpart of ``repro.fleet.workload``:

    from_table4          the paper's four Table-IV scenarios tiled over
                         the constraint levels — the replication fleet
    random_fleet         procedural random topologies
    curriculum_fleets    one random fleet per curriculum stage, user
                         counts growing start → end
    poisson_round_trace  per-round Poisson arrival counts clipped to
                         [1, n_max], for round replay

The random draws use the port's threefry keys (``repro_torch.random``)
in the reference's order, so one key gives the reference's fleet and
trace bit for bit.

``FleetScenario.shard(rank, size)`` is one rank's block of a fleet for a
cells group (``repro_torch.sharding``): its cells, and its own group
index over compacted local group ids, which carries a :class:`CellBlock`
that says where the block sits in the fleet.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.device import resolve_device
from repro_torch.env.scenarios import (CONSTRAINT_ORDER, CONSTRAINTS,
                                       SCENARIOS, Scenario)
from repro_torch.kernels.orchestration import GroupIndex, group_index
from repro_torch.specs.observation import (DEFAULT_LATENCY_TARGET_MS,
                                           LATENCY_TARGET_POOL)


class CellBlock(NamedTuple):
    """Where one rank's block of cells sits in the whole fleet: what its
    cross-cell totals need, built once per deployment.  Edge groups carry
    global ids compacted to ``[0, n_groups)``; a block's local groups
    (compacted to ``[0, G_local)``, the ids its group index takes) map to
    them through ``group_ids``."""
    cell0: int                 # global id of the block's first cell
    n_cells: int               # cells in the whole fleet
    n_groups: int              # edge groups in the whole fleet
    group_ids: torch.Tensor    # (G_local,) int64 global id of each local group
    group_first: torch.Tensor  # (G_local,) int64 its first local member
    cell_group: torch.Tensor   # (C_local,) int64 each cell's global group id
    group_size: torch.Tensor   # (C_local,) int32 its group's global size

    def to(self, device) -> "CellBlock":
        return CellBlock(*(v.to(device) if isinstance(v, torch.Tensor)
                           else v for v in self))


class FleetScenario(NamedTuple):
    """Stacked per-cell scenario tensors (leading axis = cell)."""
    weak_s: torch.Tensor      # (C, n_max) bool — per end-node weak link
    weak_e: torch.Tensor      # (C,) bool       — weak edge
    n_users: torch.Tensor     # (C,) int32      — real users (≤ n_max)
    constraint: torch.Tensor  # (C,) float32    — accuracy threshold (%)
    # (C,) float32 latency target (ms); None → DEFAULT_LATENCY_TARGET_MS
    latency_target: torch.Tensor | None = None
    # (C,) int32 edge-server group ids in [0, C); None → singleton groups
    edge_group: torch.Tensor | None = None
    # the edge groups' index for the group_occupancy kernel, built once per
    # deployment (``random_fleet``, ``to``, ``with_group_index``); it must
    # index ``edge_groups()``, so replace both together or neither
    group_index: GroupIndex | None = None

    @property
    def n_cells(self) -> int:
        return self.weak_e.shape[0]

    @property
    def n_max(self) -> int:
        return self.weak_s.shape[1]

    @property
    def device(self) -> torch.device:
        return self.weak_e.device

    def user_mask(self) -> torch.Tensor:
        """(C, n_max) bool — which padded slots are real users."""
        slots = torch.arange(self.n_max, device=self.device)
        return slots[None, :] < self.n_users[:, None]

    def latency_targets(self) -> torch.Tensor:
        """(C,) float32 latency targets, default-filled when unset."""
        if self.latency_target is None:
            return torch.full((self.n_cells,), DEFAULT_LATENCY_TARGET_MS,
                              dtype=torch.float32, device=self.device)
        return self.latency_target

    def edge_groups(self) -> torch.Tensor:
        """(C,) int32 edge-group ids; unset → every cell its own group."""
        if self.edge_group is None:
            return torch.arange(self.n_cells, dtype=torch.int32,
                                device=self.device)
        return self.edge_group

    def cell(self, i: int) -> tuple[Scenario, float, int]:
        """Cell ``i`` as a (Scenario, constraint, n_users) triple for the
        single-cell exact solver.  The float32 constraint is snapped back
        to the Table-V tenths grid, so 89.9 does not come back as
        89.90000153."""
        n = int(self.n_users[i])
        weak = tuple(bool(x) for x in self.weak_s[i, :n].tolist())
        return (Scenario(f"cell{i}", weak, bool(self.weak_e[i])),
                round(float(self.constraint[i]), 4), n)

    def with_group_index(self) -> "FleetScenario":
        """This scenario with its group index, built if it has none."""
        if self.group_index is not None:
            return self
        return self._replace(group_index=group_index(self.edge_groups()))

    def to(self, device) -> "FleetScenario":
        """The scenario on ``device``, with its group index."""
        return FleetScenario(*(None if v is None else v.to(device)
                               for v in self)).with_group_index()

    def shard(self, rank: int, size: int) -> "FleetScenario":
        """Rank ``rank``'s block of ``size`` equal blocks: cells
        ``[rank·C/size, (rank+1)·C/size)`` with their edge groups
        compacted to local ids (its group index built over them) and the
        :class:`CellBlock` of global ids and sizes its cross-cell totals
        need (``group_index.block``).  Build it once per deployment."""
        C = self.n_cells
        if not 0 <= rank < size or C % size:
            raise ValueError(f"{C} cells do not divide into block {rank} "
                             f"of {size}")
        lo, hi = rank * (C // size), (rank + 1) * (C // size)
        dev = self.device
        _, glob = torch.unique(self.edge_groups(), return_inverse=True)
        sizes = torch.bincount(glob)
        glob = glob[lo:hi]
        group_ids, local = torch.unique(glob, return_inverse=True)
        pos = torch.arange(hi - lo, device=dev)
        first = torch.full((group_ids.shape[0],), hi - lo, dtype=torch.int64,
                           device=dev).scatter_reduce_(0, local, pos, "amin")
        local = local.to(torch.int32)
        cut = lambda v: None if v is None else v[lo:hi]
        return FleetScenario(
            cut(self.weak_s), cut(self.weak_e), cut(self.n_users),
            cut(self.constraint), cut(self.latency_target), edge_group=local,
            group_index=group_index(local)._replace(block=CellBlock(
                lo, C, int(sizes.shape[0]), group_ids, first, glob,
                sizes[glob].to(torch.int32))))


def random_fleet(key: torch.Tensor, n_cells: int, n_max: int = 5, *,
                 n_users_min: int = 2, n_users_max: int | None = None,
                 weak_s_prob_max: float = 0.6, weak_e_prob: float = 0.3,
                 constraint_pool=None, latency_pool=None,
                 cells_per_edge: int = 1) -> FleetScenario:
    """Procedural random topologies, as the reference's ``random_fleet``
    from the same (2,) threefry ``key``: per-cell weak-link probability
    p ~ U(0, weak_s_prob_max), weak-node flags u < p, a weak-edge flag, a
    user count in [n_users_min, n_users_max], a Table-V constraint level
    and a latency target from ``latency_pool``.  ``cells_per_edge > 1``
    co-locates consecutive cells on one edge server (``edge_group = cell
    // cells_per_edge``).  The scenario lives on the key's device, with
    its group index."""
    dev = key.device
    n_users_max = n_max if n_users_max is None else n_users_max
    if constraint_pool is None:
        constraint_pool = [CONSTRAINTS[c] for c in CONSTRAINT_ORDER]
    if latency_pool is None:
        latency_pool = LATENCY_TARGET_POOL
    k1, k2, k3, k4, k5, k6 = rnd.split(key, 6)
    p_cell = rnd.uniform(k1, (n_cells, 1)) * weak_s_prob_max
    weak_s = rnd.uniform(k2, (n_cells, n_max)) < p_cell
    weak_e = rnd.uniform(k3, (n_cells,)) < weak_e_prob
    n_users = rnd.randint(k4, (n_cells,), n_users_min, n_users_max + 1)
    pool = torch.tensor(constraint_pool, dtype=torch.float32, device=dev)
    constraint = pool[rnd.randint(k5, (n_cells,), 0, len(pool)).long()]
    lat_pool = torch.tensor(latency_pool, dtype=torch.float32, device=dev)
    latency = lat_pool[rnd.randint(k6, (n_cells,), 0, len(lat_pool)).long()]
    edge_group = (torch.arange(n_cells, dtype=torch.int32, device=dev)
                  // max(1, cells_per_edge))
    return FleetScenario(weak_s, weak_e, n_users, constraint,
                         latency_target=latency, edge_group=edge_group,
                         group_index=group_index(edge_group))


def from_table4(names=("A", "B", "C", "D"), constraints=CONSTRAINT_ORDER,
                n_users: int = 5, n_max: int | None = None,
                device="cuda") -> FleetScenario:
    """Every (Table-IV scenario × constraint level) as one fleet cell, in
    that order, on ``device`` (with its group index: singletons)."""
    dev = resolve_device(device)
    n_max = n_users if n_max is None else n_max
    ws, we, nu, cs = [], [], [], []
    for name in names:
        sc = SCENARIOS[name].for_users(n_users)
        row = np.zeros(n_max, bool)
        row[:n_users] = sc.weak_s_arr()
        for c in constraints:
            ws.append(row)
            we.append(sc.weak_e)
            nu.append(n_users)
            cs.append(CONSTRAINTS[c] if isinstance(c, str) else float(c))
    t = lambda a: torch.as_tensor(a, device=dev)
    return FleetScenario(t(np.stack(ws)), t(np.array(we)),
                         t(np.array(nu, np.int32)),
                         t(np.array(cs, np.float32))).with_group_index()


def curriculum_fleets(key: torch.Tensor, n_cells: int, epochs: int, *,
                      start: int = 2, end: int = 32, n_max: int | None = None,
                      **random_fleet_kw) -> list[FleetScenario]:
    """One :func:`random_fleet` per curriculum stage, the user-count
    ceiling growing linearly start → end over ``epochs`` stages; every
    stage has the same ``n_max`` (default ``end``), so one observation
    width serves the whole curriculum.  Stage e draws from the second key
    of the e-th ``split`` of ``key``, as the reference does."""
    n_max = end if n_max is None else n_max
    stages = []
    for e in range(epochs):
        frac = e / max(1, epochs - 1)
        cap = int(round(start + frac * (end - start)))
        key, sub = rnd.split(key)
        stages.append(random_fleet(sub, n_cells, n_max=n_max,
                                   n_users_min=min(start, cap),
                                   n_users_max=cap, **random_fleet_kw))
    return stages


def poisson_round_trace(key: torch.Tensor, scenario: FleetScenario,
                        horizon: int, rate=3.0, *, with_stats: bool = False):
    """(horizon, C) int32 per-round arrival counts for round replay, on
    the key's device: Poisson(rate) clipped to [1, n_max] (an empty round
    is filled with one request, and a burst beyond ``n_max`` loses its
    excess).  ``rate`` is a scalar or a per-cell (C,) array, cast to
    float32.  The counts are ``poisson(key, rate, (horizon, C))``, drawn
    on the CPU whatever the key's device (the card's ``log`` rounds apart
    from the CPU's), so a key gives the reference's trace bit for bit.

    ``with_stats=True`` also returns the clipping's labels: the raw and
    served totals, ``clipped_fraction`` (share of the raw Poisson mass
    the ``n_max`` ceiling discarded) and ``floor_fraction`` (share of the
    served requests that fill empty rounds)."""
    lam = torch.as_tensor(rate, dtype=torch.float32).cpu()
    lam = torch.broadcast_to(lam, (scenario.n_cells,))
    counts = rnd.poisson(key.cpu(), lam, (horizon, scenario.n_cells))
    trace = counts.clamp(1, scenario.n_max)
    if not with_stats:
        return trace.to(key.device)
    raw = int(counts.sum())
    clipped = int((counts - scenario.n_max).clamp(min=0).sum())
    floored = int((counts == 0).sum())
    served = int(trace.sum())
    stats = {
        "raw_requests": raw,
        "served_requests": served,
        "clipped_requests": clipped,
        "clipped_fraction": clipped / raw if raw else 0.0,
        "floored_rounds": floored,
        "floor_fraction": floored / served if served else 0.0,
    }
    return trace.to(key.device), stats
