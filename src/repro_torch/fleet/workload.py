"""Fleet scenarios: the stacked, padded description of C cells.

Counterpart of ``repro.fleet.workload``'s ``FleetScenario`` and
``random_fleet``.  ``random_fleet`` draws from a ``torch.Generator`` on
the host and then moves the scenario to the device, so one seed gives the
same fleet on every device; it matches the reference in distribution,
not in bits (``repro_torch.convert`` carries a reference fleet over
exactly).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.env.scenarios import CONSTRAINT_ORDER, CONSTRAINTS
from repro_torch.specs.observation import (DEFAULT_LATENCY_TARGET_MS,
                                           LATENCY_TARGET_POOL)


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

    def to(self, device) -> "FleetScenario":
        return FleetScenario(*(None if v is None else v.to(device)
                               for v in self))


def random_fleet(seed: int, n_cells: int, n_max: int = 5, *,
                 n_users_min: int = 2, n_users_max: int | None = None,
                 weak_s_prob_max: float = 0.6, weak_e_prob: float = 0.3,
                 constraint_pool=None, latency_pool=None,
                 cells_per_edge: int = 1, device="cuda") -> FleetScenario:
    """Procedural random topologies, as the reference's ``random_fleet``:
    per-cell weak-link probability p ~ U(0, weak_s_prob_max), Bernoulli(p)
    weak-node flags, a weak-edge flag, a user count in [n_users_min,
    n_users_max], a Table-V constraint level and a latency target from
    ``latency_pool``.  ``cells_per_edge > 1`` co-locates consecutive cells
    on one edge server (``edge_group = cell // cells_per_edge``)."""
    dev = resolve_device(device)
    n_users_max = n_max if n_users_max is None else n_users_max
    if constraint_pool is None:
        constraint_pool = [CONSTRAINTS[c] for c in CONSTRAINT_ORDER]
    if latency_pool is None:
        latency_pool = LATENCY_TARGET_POOL
    g = torch.Generator().manual_seed(int(seed))
    p_cell = torch.rand((n_cells, 1), generator=g) * weak_s_prob_max
    weak_s = torch.rand((n_cells, n_max), generator=g) < p_cell
    weak_e = torch.rand((n_cells,), generator=g) < weak_e_prob
    n_users = torch.randint(n_users_min, n_users_max + 1, (n_cells,),
                            generator=g, dtype=torch.int32)
    pool = torch.tensor(constraint_pool, dtype=torch.float32)
    constraint = pool[torch.randint(len(pool), (n_cells,), generator=g)]
    lat_pool = torch.tensor(latency_pool, dtype=torch.float32)
    latency = lat_pool[torch.randint(len(lat_pool), (n_cells,), generator=g)]
    edge_group = (torch.arange(n_cells, dtype=torch.int32)
                  // max(1, cells_per_edge))
    return FleetScenario(weak_s, weak_e, n_users, constraint,
                         latency_target=latency,
                         edge_group=edge_group).to(dev)
