"""ObservationSpec — the observation layout, on tensors.

Counterpart of ``repro.specs.observation`` for batched fleet encoders:
an ordered tuple of feature blocks, each encoding ``(C,)`` / ``(C,
n_max)`` semantic inputs into ``(C, width)`` float32 columns.

Blocks: ``base`` (the paper's Table-II state plus round context, width
4·n_max + 8), ``cloud_load`` (fleet-wide mean cloud occupancy, 1),
``edge_load`` (edge-group mean edge occupancy, 1), ``constraint``
(accuracy threshold and latency target, 2).  Variants: ``base``,
``contention``, ``constraint``, ``full``.  The ``economy`` block — and
with it the ``economy`` / ``full_economy`` variants — arrives with the
economy slice; asking for it raises.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

OCC_LEVELS = 8.0            # Table-II 9-level occupancy clip (0..8)
LOAD_CAP = 8.0              # cap for the per-cell mean load features
ACC_NORM = 100.0            # accuracy features are % / 100
LATENCY_NORM = 1000.0       # latency-target feature is ms / 1000
DEFAULT_LATENCY_TARGET_MS = 400.0
# Per-cell latency-target pool for procedural fleets (ms).
LATENCY_TARGET_POOL = (150.0, 250.0, 400.0, 600.0, 800.0)


class ObsInputs(NamedTuple):
    """Semantic observation inputs, stacked over cells: ``(C,)`` and
    ``(C, n_max)`` tensors.  Occupancies arrive fully resolved (background
    and couplings included).  Inputs of blocks a spec lacks may be None."""
    user: torch.Tensor        # requesting-user cursor
    n_users: torch.Tensor     # real users this round
    busy_p_s: torch.Tensor    # (C, n_max) per-slot CPU-busy flags
    busy_m_s: torch.Tensor    # (C, n_max) per-slot memory-busy flags
    weak_s: torch.Tensor      # (C, n_max) per-slot weak-link flags
    weak_e: torch.Tensor      # weak-edge flag
    busy_m_e: torch.Tensor    # edge memory-busy flag
    busy_m_c: torch.Tensor    # cloud memory-busy flag
    k_edge: torch.Tensor      # edge occupancy (incl. bg + coupling)
    k_cloud: torch.Tensor     # cloud occupancy (incl. bg + coupling)
    acc_sum: torch.Tensor     # accuracy (%) committed so far this round
    cloud_fleet: torch.Tensor | None   # fleet-wide mean cloud occupancy
    edge_group: torch.Tensor | None    # edge-group mean edge occupancy
    constraint: torch.Tensor | None    # accuracy threshold (%)
    latency_target: torch.Tensor | None  # latency target (ms)


def _col(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.float32)[:, None]


def _base(x: ObsInputs, n_max: int) -> torch.Tensor:
    n = _col(x.n_users)
    weak_e = _col(x.weak_e)
    slots = torch.arange(n_max, device=x.user.device)
    return torch.cat([
        (x.user[:, None] == slots[None, :]).to(torch.float32),
        x.busy_p_s.to(torch.float32),
        x.busy_m_s.to(torch.float32),
        x.weak_s.to(torch.float32),
        _col(x.k_edge).clamp(max=OCC_LEVELS) / OCC_LEVELS,
        _col(x.busy_m_e), weak_e,
        _col(x.k_cloud).clamp(max=OCC_LEVELS) / OCC_LEVELS,
        _col(x.busy_m_c), weak_e,
        _col(x.acc_sum) / (ACC_NORM * n),
        _col(x.user) / n,
    ], dim=-1)


def _cloud_load(x: ObsInputs, n_max: int) -> torch.Tensor:
    return _col(x.cloud_fleet).clamp(max=LOAD_CAP) / LOAD_CAP


def _edge_load(x: ObsInputs, n_max: int) -> torch.Tensor:
    return _col(x.edge_group).clamp(max=LOAD_CAP) / LOAD_CAP


def _constraint(x: ObsInputs, n_max: int) -> torch.Tensor:
    return torch.cat([_col(x.constraint) / ACC_NORM,
                      _col(x.latency_target) / LATENCY_NORM], dim=-1)


@dataclasses.dataclass(frozen=True)
class Block:
    name: str
    width: Callable[[int], int]      # n_max -> feature count
    encode: Callable[[ObsInputs, int], torch.Tensor]


BLOCKS: dict[str, Block] = {
    "base": Block("base", lambda n: 4 * n + 8, _base),
    "cloud_load": Block("cloud_load", lambda n: 1, _cloud_load),
    "edge_load": Block("edge_load", lambda n: 1, _edge_load),
    "constraint": Block("constraint", lambda n: 2, _constraint),
}

SPEC_VARIANTS: dict[str, tuple[str, ...]] = {
    "base": ("base",),
    "contention": ("base", "cloud_load", "edge_load"),
    "constraint": ("base", "constraint"),
    "full": ("base", "cloud_load", "edge_load", "constraint"),
}
# variants the reference knows that wait for a later slice of the port
LATER_VARIANTS = ("economy", "full_economy")
SPEC_NAMES = tuple(SPEC_VARIANTS) + LATER_VARIANTS


@dataclasses.dataclass(frozen=True)
class ObservationSpec:
    """Ordered feature-block composition for one observation width."""
    name: str
    n_max: int
    blocks: tuple[str, ...]

    @property
    def dim(self) -> int:
        return sum(BLOCKS[b].width(self.n_max) for b in self.blocks)

    def encode(self, x: ObsInputs) -> torch.Tensor:
        """Batched observation: (C, dim) float32."""
        return torch.cat([BLOCKS[b].encode(x, self.n_max)
                          for b in self.blocks], dim=-1)


def make_spec(name: str, n_max: int) -> ObservationSpec:
    """Spec by variant name (``base|contention|constraint|full``)."""
    if name in LATER_VARIANTS:
        raise NotImplementedError(
            f"observation spec {name!r} needs the 'economy' block, which "
            f"arrives with the port's economy slice")
    if name not in SPEC_VARIANTS:
        raise ValueError(f"unknown observation spec {name!r}; "
                         f"choose from {SPEC_NAMES}")
    return ObservationSpec(name, n_max, SPEC_VARIANTS[name])


def spec_dim(spec_or_dim) -> int:
    """Input width from an ``ObservationSpec`` or a plain int."""
    if isinstance(spec_or_dim, ObservationSpec):
        return spec_or_dim.dim
    return int(spec_or_dim)
