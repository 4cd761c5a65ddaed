"""The paper's experimental scenarios (Table IV) and accuracy-constraint
levels (Table V), copied from the reference.

Each scenario fixes the regular/weak network condition of the five end
nodes S1–S5 and the edge E.  Constraint levels: Min (72.8%), 80%, 85%,
89%, Max (89.9%).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    weak_s: tuple[bool, ...]  # per end node
    weak_e: bool

    def for_users(self, n: int) -> "Scenario":
        return Scenario(self.name, self.weak_s[:n], self.weak_e)

    @property
    def n_users(self) -> int:
        return len(self.weak_s)

    def weak_s_arr(self) -> np.ndarray:
        return np.asarray(self.weak_s, bool)


# Table IV: R = regular, W = weak.
SCENARIOS = {
    "A": Scenario("A", (False, False, False, False, False), False),
    "B": Scenario("B", (False, True, False, True, False), True),
    "C": Scenario("C", (True, True, True, False, False), False),
    "D": Scenario("D", (True, True, True, True, True), True),
}

CONSTRAINTS = {
    "Min": 72.8,
    "80%": 80.0,
    "85%": 85.0,
    "89%": 89.0,
    "Max": 89.9,
}
CONSTRAINT_ORDER = ("Min", "80%", "85%", "89%", "Max")
