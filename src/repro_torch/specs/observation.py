"""ObservationSpec — the observation layout, on tensors.

Counterpart of ``repro.specs.observation``: an ordered tuple of feature
blocks, each encoding ``(C,)`` / ``(C, n_max)`` semantic inputs into
``(C, width)`` float32 columns (``encode``, the fleet's), or one cell's
scalars and ``(n_max,)`` arrays into a ``(width,)`` row (``encode_np``,
the single-cell env's: numpy in float64, cast to float32 once at the
end, byte for byte the reference's row).

Blocks: ``base`` (the paper's Table-II state plus round context, width
4·n_max + 8), ``cloud_load`` (fleet-wide mean cloud occupancy, 1),
``edge_load`` (edge-group mean edge occupancy, 1), ``constraint``
(accuracy threshold and latency target, 2), ``economy`` (per tier of
local, edge and cloud: startup state, ticks until it can serve and
routing price, 3·3 = 9; with no economy state given it encodes the
neutral fleet, every tier warm, instant and free).  Variants: ``base``,
``contention``, ``constraint``, ``full``, ``economy`` (base + economy)
and ``full_economy`` (full + economy).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

OCC_LEVELS = 8.0            # Table-II 9-level occupancy clip (0..8)
LOAD_CAP = 8.0              # cap for the per-cell mean load features
ACC_NORM = 100.0            # accuracy features are % / 100
LATENCY_NORM = 1000.0       # latency-target feature is ms / 1000
DEFAULT_LATENCY_TARGET_MS = 400.0
# Economy-block normalization: warmup-remaining is clipped at WARMUP_NORM
# ticks; routing prices ($/request-second) are clipped at ECON_PRICE_NORM.
WARMUP_NORM = 64.0
ECON_PRICE_NORM = 0.01
# Per-cell latency-target pool for procedural fleets (ms).
LATENCY_TARGET_POOL = (150.0, 250.0, 400.0, 600.0, 800.0)


class ObsInputs(NamedTuple):
    """Semantic observation inputs, stacked over cells: ``(C,)`` and
    ``(C, n_max)`` tensors (for ``encode_np``: one cell's scalars and
    ``(n_max,)`` arrays).  Occupancies arrive fully resolved (background
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
    # economy-block inputs; None encodes the neutral always-warm, free fleet
    econ_state: torch.Tensor | None = None       # (C, 3) 0 cold .. 2 warm
    econ_warm_ticks: torch.Tensor | None = None  # (C, 3) ticks until served
    econ_price: torch.Tensor | None = None       # (C, 3) $/req-s


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


def _economy(x: ObsInputs, n_max: int) -> torch.Tensor:
    if x.econ_state is None:
        out = torch.zeros((x.user.shape[0], 9), dtype=torch.float32,
                          device=x.user.device)
        out[:, 0::3] = 1.0  # neutral: every tier warm, instant, free
        return out
    # each division by a constant is the product with its reciprocal,
    # as the reference's compiled observe evaluates it
    st = x.econ_state.to(torch.float32) * 0.5
    wu = (x.econ_warm_ticks.to(torch.float32).clamp(max=WARMUP_NORM)
          * (1.0 / WARMUP_NORM))
    pr = (x.econ_price.to(torch.float32).clamp(max=ECON_PRICE_NORM)
          * (1.0 / ECON_PRICE_NORM))
    return torch.stack([st, wu, pr], dim=-1).reshape(st.shape[0], -1)


# ------------------------------------------- single-cell (numpy) encoders
# float64 throughout, as the reference's: the float32 encoders above
# round ``acc_sum / (ACC_NORM · n)`` and ``u / n`` apart in the last bit,
# which the tabular baseline's and the planner's rounded keys would see
def _base_np(x: ObsInputs, n_max: int) -> np.ndarray:
    onehot = np.zeros(n_max)
    u = int(x.user)
    if u < n_max:
        onehot[u] = 1.0
    n = float(x.n_users)
    return np.concatenate([
        onehot,
        np.asarray(x.busy_p_s, float),
        np.asarray(x.busy_m_s, float),
        np.asarray(x.weak_s, float),
        [min(float(x.k_edge), OCC_LEVELS) / OCC_LEVELS,
         float(x.busy_m_e), float(x.weak_e)],
        [min(float(x.k_cloud), OCC_LEVELS) / OCC_LEVELS,
         float(x.busy_m_c), float(x.weak_e)],
        [float(x.acc_sum) / (ACC_NORM * n), u / n],
    ])


def _cloud_load_np(x: ObsInputs, n_max: int) -> np.ndarray:
    return np.array([min(float(x.cloud_fleet), LOAD_CAP) / LOAD_CAP])


def _edge_load_np(x: ObsInputs, n_max: int) -> np.ndarray:
    return np.array([min(float(x.edge_group), LOAD_CAP) / LOAD_CAP])


def _constraint_np(x: ObsInputs, n_max: int) -> np.ndarray:
    return np.array([float(x.constraint) / ACC_NORM,
                     float(x.latency_target) / LATENCY_NORM])


def _economy_np(x: ObsInputs, n_max: int) -> np.ndarray:
    if x.econ_state is None:
        out = np.zeros(9)
        out[0::3] = 1.0  # neutral: every tier warm, instant, free
        return out
    st = np.asarray(x.econ_state, float) / 2.0
    wu = np.minimum(np.asarray(x.econ_warm_ticks, float),
                    WARMUP_NORM) / WARMUP_NORM
    pr = np.minimum(np.asarray(x.econ_price, float),
                    ECON_PRICE_NORM) / ECON_PRICE_NORM
    return np.stack([st, wu, pr], axis=-1).reshape(-1)


@dataclasses.dataclass(frozen=True)
class Block:
    name: str
    width: Callable[[int], int]      # n_max -> feature count
    encode: Callable[[ObsInputs, int], torch.Tensor]
    encode_np: Callable[[ObsInputs, int], np.ndarray]


BLOCKS: dict[str, Block] = {
    "base": Block("base", lambda n: 4 * n + 8, _base, _base_np),
    "cloud_load": Block("cloud_load", lambda n: 1, _cloud_load,
                        _cloud_load_np),
    "edge_load": Block("edge_load", lambda n: 1, _edge_load, _edge_load_np),
    "constraint": Block("constraint", lambda n: 2, _constraint,
                        _constraint_np),
    # 3 tiers × (startup state, ticks-to-warm, routing price)
    "economy": Block("economy", lambda n: 9, _economy, _economy_np),
}

SPEC_VARIANTS: dict[str, tuple[str, ...]] = {
    "base": ("base",),
    "contention": ("base", "cloud_load", "edge_load"),
    "constraint": ("base", "constraint"),
    "full": ("base", "cloud_load", "edge_load", "constraint"),
    "economy": ("base", "economy"),
    "full_economy": ("base", "cloud_load", "edge_load", "constraint",
                     "economy"),
}
SPEC_NAMES = tuple(SPEC_VARIANTS)


@dataclasses.dataclass(frozen=True)
class ObservationSpec:
    """Ordered feature-block composition for one observation width."""
    name: str
    n_max: int
    blocks: tuple[str, ...]

    @property
    def dim(self) -> int:
        return sum(BLOCKS[b].width(self.n_max) for b in self.blocks)

    def block_slices(self) -> dict[str, slice]:
        """Feature-index slice of every block."""
        out, lo = {}, 0
        for b in self.blocks:
            hi = lo + BLOCKS[b].width(self.n_max)
            out[b] = slice(lo, hi)
            lo = hi
        return out

    def encode(self, x: ObsInputs) -> torch.Tensor:
        """Batched observation: (C, dim) float32."""
        return torch.cat([BLOCKS[b].encode(x, self.n_max)
                          for b in self.blocks], dim=-1)

    def encode_np(self, x: ObsInputs) -> np.ndarray:
        """One cell's observation, numpy: (dim,) float32."""
        return np.concatenate([BLOCKS[b].encode_np(x, self.n_max)
                               for b in self.blocks]).astype(np.float32)


def make_spec(name: str, n_max: int) -> ObservationSpec:
    """Spec by variant name (one of ``SPEC_NAMES``)."""
    if name not in SPEC_VARIANTS:
        raise ValueError(f"unknown observation spec {name!r}; "
                         f"choose from {SPEC_NAMES}")
    return ObservationSpec(name, n_max, SPEC_VARIANTS[name])


def spec_dim(spec_or_dim) -> int:
    """Input width from an ``ObservationSpec`` or a plain int."""
    if isinstance(spec_or_dim, ObservationSpec):
        return spec_or_dim.dim
    return int(spec_or_dim)
