"""The port's fleet Hybrid Learning trainer (``repro_torch.hltrain``)
against ``repro.hltrain``.

* **State carried in.**  The reference's initial ``HLTrainState``
  (16 cells, n_max 4, ``full`` spec, shared cloud and edge, 4 cells per
  edge, a tiny schedule whose plan ring wraps) crosses with
  ``convert.hl_train_state``; both packages train it 2 epochs.  Every
  integer is identical — counters, ring pointers and sizes, buffer
  actions and done flags, plan keys, the env's state and key, the
  per-epoch counts.  The only difference the rule allows is an argmax at
  a near-tie (top two Q-values within 1e-4, where the two libraries'
  float32 products may round apart).  Both run epoch by epoch; where a
  direct action first differs (in time order: D_direct does not wrap),
  the carry is identical up to the epoch before, and the gap between the
  top two Q-values at that step, under the weights that chose the action,
  must be under 1e-4; the test says so and stops (this configuration has
  no such tie: every action is identical).  Those weights are the port's,
  recorded at every direct step: the reference's lie inside its compiled
  epoch, and the port's match them within the parameter bar up to the
  epoch that differs.
  Float buffers (states, rewards, priorities) within 1e-5; parameters and Adam moments within 2e-6 (measured on the CPU:
  4.8e-7 at most, in the system model's first moments); the metrics
  within 1e-5.
* **Init from the same key.**  Env state, ``eps_scale``, counters and
  buffers bit-equal; weights within 5e-7 (``random.normal``'s bar);
  observations within 1e-6.
* **Accounting.**  ``session_schedule`` and ``real_step_budget`` equal
  the reference's; the trainer's ``direct_steps`` equals the budget;
  ``run_curriculum``'s chunks and stage swaps are
  ``tests/test_hltrain.py``'s.
* **The reward band** of ``tests/test_hltrain.py``: the port's trained
  greedy policy on B/85%, n = 3, 60 epochs, has ART within 2× the exact
  optimum and no violation.
"""
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.fleet import FleetConfig as RefFleetConfig
from repro.fleet import curriculum_fleets as ref_curriculum_fleets
from repro.fleet import random_fleet as ref_random_fleet
from repro.hltrain import FleetHLParams as RefParams
from repro.hltrain import make_hl_trainer as ref_make_hl_trainer
from repro.hltrain import real_step_budget as ref_budget
from repro.hltrain import session_schedule as ref_schedule
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.fleet import FleetConfig, from_table4, random_fleet
from repro_torch.fleet.solver import solve_fleet
from repro_torch.fleet.workload import curriculum_fleets
from repro_torch.hltrain import (FleetHLParams, evaluate_vs_solver,
                                 history_to_dict, make_hl_trainer,
                                 real_step_budget, run_curriculum,
                                 session_schedule)
from repro_torch.core.dqn import make_dqn
from repro_torch.hltrain import trainer as trainer_mod
from repro_torch.hltrain.trainer import train_telemetry_report

CPU = torch.device("cpu")
CELLS, N_MAX = 16, 4
CFG = dict(n_max=N_MAX, obs_spec="full", shared_cloud=True, shared_edge=True)
TINY = dict(epochs=2, n_direct=3, t_direct=6, n_world=6, n_suggest=2,
            t_suggest=3, n_plan=6, k_best=3, batch=16, direct_cap=512,
            world_cap=512, plan_cap=256)
# measured: 4.8e-7 (the system model's first moments), 6e-8 elsewhere
PARAM_BAR = 2e-6
# the two libraries may round a Q-value apart: an argmax may flip only
# where the top two lie closer than this
NEAR_TIE = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tensors this small gain nothing from intra-op threads, whose idle
    pool spins on the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(seed):
    k = jax.random.PRNGKey(seed)
    return k, convert.key_from_data(np.asarray(k), CPU)


def _tree(x):
    """A reference pytree of NamedTuples, dicts and lists as nested dicts
    and lists of numpy arrays (the layout of
    ``convert.hl_train_state_arrays``)."""
    if hasattr(x, "_fields"):
        return {f: _tree(getattr(x, f)) for f in x._fields
                if getattr(x, f) is not None}
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v) for v in x]
    return np.array(x)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _bar(path: str):
    """None: identical; else the absolute bar of a float leaf."""
    if path.startswith((".dqn", ".sm")):
        return PARAM_BAR
    return 1e-5


def _recording_make_dqn(record: list):
    """A ``make_dqn`` whose ``q_values`` also keeps, in order, the Q-values
    of every direct step's greedy choice (a (C, D) observation; planning
    passes (C, A, D) model states)."""
    def make(*args, **kw):
        init, q_values, update, sync = make_dqn(*args, **kw)

        def q(params, s):
            out = q_values(params, s)
            if s.dim() == 2:
                record.append(out.numpy().copy())
            return out
        return init, q, update, sync
    return make


def _assert_carry(got: dict, want: dict, n_cells: int, q_steps=None):
    """Every leaf of the port's carry against the reference's.  Where a
    direct action differs, the gap between the top two of ``q_steps``
    (the Q-values of each direct step, in order) at its step and cell
    must be a near-tie, and the comparison stops there: past it the two
    runs train apart.  Returns the first difference, or None."""
    g = dict(_leaves(got))
    w = dict(_leaves(want))
    assert g.keys() == w.keys()
    a_g, a_w = g[".d_direct.ring.a"], w[".d_direct.ring.a"]
    if not np.array_equal(a_g, a_w):
        slot = int(np.flatnonzero(a_g != a_w)[0])
        assert q_steps is not None, f"direct actions differ at {slot}"
        # time order: every direct row is still in its slot
        assert len(q_steps) * n_cells == int(w[".d_direct.ring.size"])
        step, cell = divmod(slot, n_cells)
        q = np.sort(q_steps[step][cell])
        gap = float(q[-1] - q[-2])
        assert gap < NEAR_TIE, (f"direct actions differ first at step "
                                f"{step}, cell {cell}, Q gap {gap}")
        return dict(step=step, cell=cell, q_gap=gap)
    for path, want_v in w.items():
        got_v = g[path]
        assert got_v.shape == want_v.shape, path
        if want_v.dtype.kind == "f":
            np.testing.assert_allclose(got_v, want_v, atol=_bar(path),
                                       rtol=0, err_msg=path)
        else:
            np.testing.assert_array_equal(got_v, want_v, err_msg=path)
    return None


def _trainers(**hp):
    kw = dict(TINY, **hp)
    return (ref_make_hl_trainer(RefFleetConfig(**CFG), RefParams(**kw)),
            make_hl_trainer(FleetConfig(**CFG), FleetHLParams(**kw)))


def _fleet(seed=0):
    ref = ref_random_fleet(jax.random.PRNGKey(seed), CELLS, n_max=N_MAX,
                           cells_per_edge=4)
    return ref, convert.fleet_scenario(ref, CPU)


def test_init_from_the_same_key_matches_reference():
    ref_tr, tr = _trainers()
    ref_scn, scn = _fleet()
    rk, pk = _key(1)
    want = _tree(ref_tr.init(rk, ref_scn))
    got = convert.hl_train_state_arrays(tr.init(pk, scn))
    for path, w in _leaves(want):
        g = dict(_leaves(got))[path]
        if path.startswith((".dqn.params", ".dqn.target_params",
                            ".sm.params")):
            np.testing.assert_allclose(g, w, atol=5e-7, rtol=0,
                                       err_msg=path)
        elif path == ".obs":
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
        else:  # env state, eps_scale, buffers, moments, counters
            np.testing.assert_array_equal(g, w, err_msg=path)


def test_carried_state_trains_as_the_reference(monkeypatch):
    q_steps: list = []
    monkeypatch.setattr(trainer_mod, "make_dqn",
                        _recording_make_dqn(q_steps))
    ref_tr, tr = _trainers()
    ref_scn, scn = _fleet()
    ref_state = ref_tr.init(jax.random.PRNGKey(1), ref_scn)
    state = convert.hl_train_state(ref_state, CPU)
    # the crossing itself is exact
    _assert_carry(convert.hl_train_state_arrays(state), _tree(ref_state),
                  CELLS)
    for e in range(TINY["epochs"]):
        ref_state, ref_m = ref_tr.run(ref_state, ref_scn, e, 1)
        state, m = tr.run(state, scn, e, 1)
        tie = _assert_carry(convert.hl_train_state_arrays(state),
                            _tree(ref_state), CELLS, q_steps)
        if tie is not None:  # a near-tie: the runs part here
            warnings.warn(f"identical up to a near-tie at epoch {e}: {tie}")
            return
        hist = history_to_dict(m)
        for k, v in ref_m.items():
            np.testing.assert_allclose(hist[k], np.asarray(v), atol=1e-5,
                                       rtol=1e-6, err_msg=k)
    # the plan ring wrapped and both packages verified the same pairs
    assert int(state.verify_steps) > TINY["plan_cap"]


def test_run_in_chunks_continues_from_the_returned_carry():
    """``run`` consumes its input carry; the state it returns is the one
    to continue from: two one-epoch calls leave the carry of one
    two-epoch call, bit for bit."""
    _, tr = _trainers()
    _, scn = _fleet()
    whole, _ = tr.run(tr.init(rnd.PRNGKey(1, CPU), scn), scn, 0, 2)
    part, _ = tr.run(tr.init(rnd.PRNGKey(1, CPU), scn), scn, 0, 1)
    part, _ = tr.run(part, scn, 1, 1)
    got = dict(_leaves(convert.hl_train_state_arrays(part)))
    for path, want in _leaves(convert.hl_train_state_arrays(whole)):
        np.testing.assert_array_equal(got[path], want, err_msg=path)


@pytest.mark.parametrize("hp", [
    dict(epochs=1), dict(epochs=4), dict(epochs=5, n_direct=3, n_world=6),
    dict(epochs=60), dict(epochs=61, n_suggest=7, n_plan=5),
    dict(epochs=6, n_direct=3, t_direct=6, n_world=6, n_suggest=2,
         t_suggest=3, n_plan=6)])
def test_schedule_and_budget_equal_the_reference(hp):
    want = ref_schedule(RefParams(**hp))
    got = session_schedule(FleetHLParams(**hp))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for cells, epochs in ((1, None), (65536, None), (320, 1)):
        assert real_step_budget(FleetHLParams(**hp), cells, epochs) == \
            ref_budget(RefParams(**hp), cells, epochs)


def _tiny_hp(**kw):
    base = dict(epochs=6, n_direct=3, t_direct=6, n_world=6, n_suggest=2,
                t_suggest=3, n_plan=6, k_best=3, batch=32, seed=0,
                eps_cell_jitter=0.0, direct_cap=4096, world_cap=4096)
    base.update(kw)
    return FleetHLParams(**base)


def test_direct_steps_equal_the_budget_one_cell():
    """``tests/test_hltrain.py``'s 1-cell accounting: the trainer's direct
    counter equals the closed-form budget, verifications stay inside
    theirs."""
    hp = _tiny_hp()
    scn = from_table4(names=("B",), constraints=("85%",), device=CPU)
    trainer = make_hl_trainer(FleetConfig(n_max=5), hp)
    state = trainer.init(rnd.PRNGKey(0, CPU), scn)
    state, _ = trainer.run(state, scn, 0, hp.epochs)
    budget = real_step_budget(hp, n_cells=1)
    assert int(state.direct_steps) == budget["direct_steps"]
    assert 0 < int(state.verify_steps) <= budget["verify_steps_max"]
    assert int(state.real_steps) == (int(state.direct_steps)
                                     + int(state.verify_steps))


def test_run_curriculum_epoch_accounting_and_stage_swaps():
    """Chunked stages reproduce the direct budget, the last chunk is cut
    to the epoch total, and only a real scenario swap aborts rounds."""
    hp = _tiny_hp(epochs=5)
    trainer = make_hl_trainer(FleetConfig(n_max=4), hp)
    stages = curriculum_fleets(rnd.PRNGKey(0, CPU), 4, 3, start=2, end=4)
    seen = []
    state = run_curriculum(trainer, stages, hp.epochs, 2,
                           rnd.PRNGKey(1, CPU),
                           on_stage=lambda s, scn, st, m: seen.append(
                               m["epoch"].tolist()))
    assert seen == [[0, 1], [2, 3], [4]]
    assert int(state.direct_steps) == real_step_budget(
        hp, n_cells=4)["direct_steps"]
    # a repeated fixed fleet (one object) does not abort rounds: the same
    # budget, the round cursor carried across chunks
    fixed = [stages[0]] * 3
    st2 = run_curriculum(trainer, fixed, hp.epochs, 2, rnd.PRNGKey(1, CPU))
    assert int(st2.direct_steps) == int(state.direct_steps)
    # the stages are the reference's draws
    ref_stages = ref_curriculum_fleets(jax.random.PRNGKey(0), 4, 3, start=2,
                                       end=4)
    for got, want in zip(stages, ref_stages, strict=True):
        for f in ("weak_s", "weak_e", "n_users", "constraint"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))


def test_trainer_derives_dims_from_spec_full():
    cfg = FleetConfig(**CFG)
    trainer = make_hl_trainer(cfg, _tiny_hp(epochs=2, batch=16))
    scn = random_fleet(rnd.PRNGKey(0, CPU), 8, n_max=N_MAX, n_users_min=2,
                       cells_per_edge=4)
    state = trainer.init(rnd.PRNGKey(1, CPU), scn)
    assert state.obs.shape == (8, cfg.state_dim)
    assert state.d_direct.ring.s.shape[1] == cfg.state_dim
    assert state.dqn.params.sizes[0] == cfg.state_dim
    state, _ = trainer.run(state, scn, 0, 2)
    assert int(state.real_steps) > 0
    ev = evaluate_vs_solver(state.dqn.params, scn, cfg)
    assert 0.0 <= ev["violation_rate"] <= 1.0


def test_telemetry_waits_for_its_slice():
    """The trainer's telemetry is in: a trainer with it builds and
    carries a buffer of one window per direct-session slot; live export
    without it and a report from a trainer without it raise the
    reference's ``ValueError``."""
    hp = _tiny_hp(epochs=2, telemetry=True)
    trainer = make_hl_trainer(FleetConfig(n_max=N_MAX), hp)
    scn = random_fleet(rnd.PRNGKey(0, CPU), 4, n_max=N_MAX)
    state = trainer.init(rnd.PRNGKey(1, CPU), scn)
    assert state.tel.n_windows == hp.epochs * hp.n_direct
    with pytest.raises(ValueError, match="telemetry"):
        make_hl_trainer(FleetConfig(), FleetHLParams(), live=object())
    off = make_hl_trainer(FleetConfig(n_max=N_MAX), _tiny_hp(epochs=2))
    with pytest.raises(ValueError, match="telemetry"):
        train_telemetry_report(off.init(rnd.PRNGKey(1, CPU), scn))


def test_reward_band_one_cell():
    """``tests/test_hltrain.py``'s band: after 60 epochs on B/85% with
    3 users, the greedy policy is feasible and within 2× the exact
    optimum's ART (the buffers hold the run's 3,580 transitions without
    wrapping, so their capacity does not change a draw)."""
    scn = from_table4(names=("B",), constraints=("85%",), n_users=3,
                      device=CPU)
    cfg = FleetConfig(n_max=3)
    hp = FleetHLParams(epochs=60, eps_decay_steps=1000, batch=64, seed=0,
                       updates_per_direct=2, updates_per_plan=2,
                       direct_cap=4096, world_cap=4096)
    trainer = make_hl_trainer(cfg, hp)
    state = trainer.init(rnd.PRNGKey(0, CPU), scn)
    state, _ = trainer.run(state, scn, 0, hp.epochs)
    assert int(state.d_direct.ring.size) < hp.direct_cap
    ev = evaluate_vs_solver(state.dqn.params, scn, cfg)
    opt_art = float(solve_fleet(scn)["art"][0])
    assert ev["violation_rate"] == 0.0
    assert float(ev["art"].mean()) <= 2.0 * opt_art + 1e-9
    assert int(state.direct_steps) == real_step_budget(
        hp, n_cells=1)["direct_steps"]
