"""The port's workload draws against the reference's.

* ``from_table4`` and every stage of ``curriculum_fleets`` bit-equal to
  the reference's (the curriculum from the same threefry key), and
  ``FleetScenario.cell`` the same (Scenario, snapped constraint, n)
  triples.
* ``poisson_round_trace`` bit-equal from the same key, with its clipping
  stats, at a scalar rate and at per-cell rates on both sides of the
  Poisson sampler's branch threshold (lam 10).
* The Table-IV scenarios and the numpy latency model equal the
  reference's.
"""
import jax
import numpy as np
import pytest
import torch

from repro.env import latency_model as ref_lm
from repro.env.scenarios import SCENARIOS as REF_SCENARIOS
from repro.fleet import workload as ref_workload
from repro_torch import convert
from repro_torch.env import latency_model as lm
from repro_torch.env.scenarios import SCENARIOS
from repro_torch.fleet import workload

CPU = torch.device("cpu")
REF_FIELDS = ("weak_s", "weak_e", "n_users", "constraint", "latency_target",
              "edge_group")


def _assert_scenarios_equal(got, want):
    for f in REF_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if w is not None:
            w = np.asarray(w)
            g = g.numpy()
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, f)
    assert got.group_index is not None
    assert torch.equal(got.group_index.groups, got.edge_groups())


def _cell(scn, i):
    """``scn.cell(i)`` with its Scenario as plain fields (the two
    packages' Scenario classes never compare equal)."""
    sc, c, n = scn.cell(i)
    return (sc.name, sc.weak_s, sc.weak_e), c, n


def _key(seed):
    k = jax.random.PRNGKey(seed)
    return k, convert.key_from_data(np.asarray(k), CPU)


@pytest.mark.parametrize("kw", [
    {},
    dict(names=("B", "D"), constraints=("Min", "Max")),
    dict(n_users=3, n_max=6, constraints=(80.0, "89%", 89.9)),
])
def test_from_table4_matches_reference(kw):
    want = ref_workload.from_table4(**kw)
    got = workload.from_table4(**kw, device=CPU)
    _assert_scenarios_equal(got, want)
    for i in range(got.n_cells):
        assert _cell(got, i) == _cell(want, i)


@pytest.mark.parametrize("seed,cells,epochs,kw", [
    (0, 16, 4, {}),
    (3, 40, 3, dict(start=2, end=5)),
    (5, 9, 5, dict(start=1, end=8, n_max=10, cells_per_edge=3,
                   weak_e_prob=0.5)),
])
def test_curriculum_fleets_match_reference(seed, cells, epochs, kw):
    ref_key, key = _key(seed)
    want = ref_workload.curriculum_fleets(ref_key, cells, epochs, **kw)
    got = workload.curriculum_fleets(key, cells, epochs, **kw)
    assert len(got) == len(want) == epochs
    for g, w in zip(got, want):
        _assert_scenarios_equal(g, w)
        # the reference's scenario carried across equals the port's draw
        _assert_scenarios_equal(convert.fleet_scenario(w, CPU), w)
    caps = [int(s.n_users.max()) for s in got]
    assert caps == sorted(caps)


def test_cell_snaps_float32_constraints():
    ref_key, key = _key(2)
    want = ref_workload.random_fleet(ref_key, 50, n_max=5)
    got = workload.random_fleet(key, 50, n_max=5)
    cells = [_cell(got, i) for i in range(50)]
    assert cells == [_cell(want, i) for i in range(50)]
    assert {c for _, c, _ in cells} <= {72.8, 80.0, 85.0, 89.0, 89.9}


@pytest.mark.parametrize("seed,cells,horizon,rate", [
    (0, 7, 5, 3.0),
    (1, 64, 6, 3.0),
    (2, 30, 4, "per_cell"),       # lam in [0, 14): both sampler branches
    (3, 12, 3, 0.4),              # mostly empty rounds: the floor fills
])
def test_poisson_round_trace_matches_reference(seed, cells, horizon, rate):
    ref_key, key = _key(seed)
    scn_ref = ref_workload.random_fleet(jax.random.PRNGKey(seed + 10),
                                        cells, n_max=5)
    scn = convert.fleet_scenario(scn_ref, CPU)
    if rate == "per_cell":
        rate = np.random.default_rng(seed).uniform(0.0, 14.0, cells)
        assert (rate > 10).any() and (rate < 10).any()
    want, want_stats = ref_workload.poisson_round_trace(
        ref_key, scn_ref, horizon, rate=rate, with_stats=True)
    got, stats = workload.poisson_round_trace(key, scn, horizon, rate=rate,
                                              with_stats=True)
    assert got.dtype == torch.int32 and got.device == CPU
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats == want_stats
    plain = workload.poisson_round_trace(key, scn, horizon, rate=rate)
    assert torch.equal(plain, got)


def test_table4_scenarios_and_numpy_model_match_reference():
    assert SCENARIOS == {k: type(SCENARIOS[k])(v.name, v.weak_s, v.weak_e)
                         for k, v in REF_SCENARIOS.items()}
    rng = np.random.default_rng(0)
    for _ in range(50):
        n = int(rng.integers(1, 9))
        a = rng.integers(0, lm.N_ACTIONS, n)
        weak = rng.random(n) < 0.5
        bg = dict(busy_p_s=rng.random(n) < 0.3, busy_m_s=rng.random(n) < 0.3,
                  busy_m_e=bool(rng.random() < 0.3),
                  busy_m_c=bool(rng.random() < 0.3),
                  bg_edge=int(rng.integers(0, 3)),
                  bg_cloud=int(rng.integers(0, 3)))
        we = bool(rng.random() < 0.5)
        np.testing.assert_array_equal(
            lm.response_times(a, weak, we, **bg),
            ref_lm.response_times(a, weak, we, **bg))
        np.testing.assert_array_equal(lm.action_accuracy(a),
                                      ref_lm.action_accuracy(a))
