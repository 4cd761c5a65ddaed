"""The port's exact solver, and its memoised fleet tables, against the
reference's ``repro.fleet.solver`` and ``solve_oracle``.

* ``solve_optimal``: ``actions``, ``art``, ``acc`` and ``objective``
  bit-equal at every Table-IV scenario × Table-V constraint for n = 1..5,
  at random scenarios with n ≤ 8, at n = 32, and under non-default tier
  weights.
* ``solve_fleet`` and ``solve_oracle`` (one solver call per distinct
  argument tuple, gathered to the cells) bit-equal to the reference's
  per-cell loops on a 300-cell fleet and on a Table-IV fleet.
"""
import jax
import numpy as np
import pytest
import torch

from repro.env.scenarios import CONSTRAINTS as REF_CONSTRAINTS
from repro.env.scenarios import SCENARIOS as REF_SCENARIOS
from repro.env.scenarios import Scenario as RefScenario
from repro.fleet import solver as ref_solver
from repro.fleet import workload as ref_workload
from repro.policy.adapters import solve_oracle as ref_solve_oracle
from repro_torch import convert
from repro_torch.env.scenarios import SCENARIOS, Scenario
from repro_torch.fleet import solver, workload
from repro_torch.policy.adapters import solve_oracle

CPU = torch.device("cpu")


def _assert_same(got, want):
    assert got["actions"].dtype == want["actions"].dtype
    np.testing.assert_array_equal(got["actions"], want["actions"])
    for k in ("art", "acc", "objective"):
        assert got[k] == want[k], (k, got[k], want[k])


@pytest.mark.parametrize("name", "ABCD")
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_solve_optimal_table4_grid(name, n):
    for c in REF_CONSTRAINTS.values():
        _assert_same(solver.solve_optimal(SCENARIOS[name], c, n),
                     ref_solver.solve_optimal(REF_SCENARIOS[name], c, n))


@pytest.mark.parametrize("seed,n_hi,kw", [
    (0, 8, {}),
    (1, 32, {}),
    (2, 8, dict(tier_scale=(1.0, 0.7, 1.6), tier_offset=(5.0, 0.0, 12.5))),
    (3, 32, dict(tier_scale=(2.0, 1.0, 0.5), tier_offset=(0.0, 3.0, 0.0))),
])
def test_solve_optimal_random_scenarios(seed, n_hi, kw):
    """Random weak flags, constraints and n ≤ 8, or n = 32."""
    rng = np.random.default_rng(seed)
    levels = list(REF_CONSTRAINTS.values())
    for i in range(12 if n_hi == 8 else 2):
        n = int(rng.integers(1, 9)) if n_hi == 8 else 32
        weak = tuple(bool(x) for x in rng.random(n) < 0.4)
        weak_e = bool(rng.random() < 0.4)
        c = levels[int(rng.integers(0, len(levels)))]
        got = solver.solve_optimal(Scenario(f"s{i}", weak, weak_e), c, n,
                                   **kw)
        want = ref_solver.solve_optimal(RefScenario(f"s{i}", weak, weak_e),
                                        c, n, **kw)
        _assert_same(got, want)


def test_solve_optimal_refuses_an_unsatisfiable_constraint():
    with pytest.raises(ValueError, match="unsatisfiable"):
        solver.solve_optimal(SCENARIOS["A"], 95.0, 3)


@pytest.mark.parametrize("fleet", ["random_300", "table4"])
def test_fleet_tables_match_the_reference_loops(fleet):
    if fleet == "random_300":
        ref_scn = ref_workload.random_fleet(jax.random.PRNGKey(7), 300,
                                            n_max=5, cells_per_edge=4)
    else:
        ref_scn = ref_workload.from_table4(n_users=4, n_max=5)
    scn = convert.fleet_scenario(ref_scn, CPU)
    want, got = ref_solver.solve_fleet(ref_scn), solver.solve_fleet(scn)
    for k in ("art", "acc"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], k)
    want, got = ref_solve_oracle(ref_scn), solve_oracle(scn)
    for k in ("actions", "art", "acc"):
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], k)


def test_solve_cells_calls_the_solver_once_per_distinct_tuple(monkeypatch):
    calls = []
    plain = solver.solve_optimal
    monkeypatch.setattr(solver, "solve_optimal",
                        lambda *a, **k: calls.append(a) or plain(*a, **k))
    scn = workload.random_fleet(convert.key_from_data(
        np.asarray(jax.random.PRNGKey(8)), CPU), 2000, n_max=5)
    out = solve_oracle(scn)
    # at most 2^n weak patterns x 2 edges x 5 levels per n
    assert len(calls) <= sum(2 ** n * 2 * 5 for n in range(1, 6))
    args = {(sc.weak_s, sc.weak_e, c, n) for sc, c, n in calls}
    assert len(args) == len(calls)
    assert out["actions"].shape == (2000, 5, 5)
