"""The port's tier economy against the reference's.

Same numpy-made inputs through ``repro.economy`` and
``repro_torch.economy`` (the reference jitted, as its serving tick runs
it): the tier state machine and its integer billing over 40 ticks, the
preemption draws at 4,096 cells, the ``economy`` observation block, the
``cost_greedy`` router, the multi-objective solver, the serving tick
under each profile, ``cost_greedy`` bundles across packages and the CLI's
``--economy``.  Integers (tier states, counters, µ$, mJ, integer
records) are held bit for bit, floats within 1e-5.  Every case is a
seeded parametrized case: nothing here draws a new example per run.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.economy import routing as ref_routing
from repro.economy import tiers as ref_tiers
from repro.env.scenarios import SCENARIOS as REF_SCENARIOS
from repro.fleet.env import FleetConfig as RefFleetConfig
from repro.fleet.env import make_fleet_env as ref_make_fleet_env
from repro.fleet.workload import random_fleet as ref_random_fleet
from repro.launch.serve_fleet import serve_bundle as ref_serve_bundle
from repro.policy import adapters as ref_adapters
from repro.policy import bundle as ref_bundle
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import poisson_request_stream as ref_poisson_stream
from repro.serve import serve_stream as ref_serve_stream
from repro.specs.observation import make_spec as ref_make_spec
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.economy import routing, tiers
from repro_torch.env.scenarios import SCENARIOS
from repro_torch.fleet.env import FleetConfig, make_fleet_env
from repro_torch.fleet.workload import random_fleet
from repro_torch.launch import serve_fleet
from repro_torch.policy import adapters, bundle
from repro_torch.serve.engine import ServeConfig, serve_stream
from repro_torch.serve.stream import poisson_request_stream
from repro_torch.specs.observation import make_spec

CPU = torch.device("cpu")
N_MAX = 5
EXACT = ("dropped", "served", "violated", "action")
CLOSE = ("wait_ms", "service_ms", "art_ms")
# every transition of the state machine within a few ticks: cold starts,
# frequent preemptions with recovery, quick scale-to-zero
STRESS = dict(
    name="stress",
    price_per_req_s=(1.0e-4, 7.0e-4, 2.4e-3),
    uptime_price_per_s=(0.0, 3.0e-4, 1.0e-4),
    energy_j_per_req=(1.5, 4.0, 10.0),
    cold_start_ticks=(0, 6, 3),
    preempt_prob=(0.0, 0.05, 0.02),
    recovery_ticks=(0, 4, 2),
    idle_timeout_ticks=(0, 5, 4),
    start_cold=(False, True, True))
PROFILES = ("local", "serverless", "spot", "stress")


def _profiles(name):
    """(reference profile, port profile) by name."""
    if name == "stress":
        return (ref_tiers.EconomyProfile(**STRESS),
                tiers.EconomyProfile(**STRESS))
    return ref_tiers.builtin_profile(name), tiers.builtin_profile(name)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def _assert_econ_equal(got, want, what):
    for f, w in _np(want).items():
        g = getattr(got, f).numpy()
        if f == "slot_penalty_ms":
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0,
                                       err_msg=f"{what}: {f}")
        else:
            assert g.dtype == w.dtype, (what, f, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, f"{what}: {f}")


# ------------------------------------------------------- the state machine
def _tick_inputs(rng, t, C, tick_ms=50.0):
    now = np.float32(1000.0 + tick_ms * t)
    return dict(
        action=rng.integers(-1, 10, C).astype(np.int32),
        cursor=rng.integers(0, N_MAX, C).astype(np.int32),
        active=rng.random(C) < 0.7,
        round_start=(now - tick_ms * rng.integers(0, 8, C)).astype(
            np.float32),
        round_actions=rng.integers(-1, 10, (C, N_MAX)).astype(np.int32),
        in_round=rng.random((C, N_MAX)) < 0.6,
        rec_mask=rng.random((C, N_MAX)) < 0.3,
        times=rng.uniform(50.0, 3000.0, (C, N_MAX)).astype(np.float32),
        fin=rng.random(C) < 0.3,
        cell_ids=np.arange(C, dtype=np.int32) + 7), now


@pytest.mark.parametrize("profile,tick_ms", [
    ("local", 50.0), ("serverless", 50.0), ("spot", 50.0), ("stress", 50.0),
    ("spot", 40.0), ("stress", 30.0)])
def test_advance_economy_matches_reference(profile, tick_ms):
    """40 ticks from a random state: tier states, warmups, idle counts,
    counters, µ$ and mJ identical every tick, slot penalties within 1e-5,
    and the tick's event sums equal."""
    C = 512
    ref_p, p = _profiles(profile)
    rng = np.random.default_rng(PROFILES.index(profile) + int(tick_ms))
    ref_adv = jax.jit(functools.partial(ref_tiers.advance_economy, ref_p,
                                        tick_ms=tick_ms))
    pen0 = np.where(rng.random((C, N_MAX)) < 0.5, 0.0,
                    rng.uniform(0.0, 2000.0, (C, N_MAX)))
    ref_e = ref_tiers.TierEconomyState(
        jnp.asarray(rng.integers(0, 3, (C, 3)), jnp.int32),
        jnp.asarray(rng.integers(0, 25, (C, 3)), jnp.int32),
        jnp.asarray(rng.integers(0, 70, (C, 3)), jnp.int32),
        jnp.asarray(pen0, jnp.float32),
        *(jnp.asarray(rng.integers(0, 10_000, C), jnp.int32)
          for _ in range(4)))
    e = convert.tier_economy_state(ref_e, CPU)
    seen = {"cold_starts": 0, "preemptions": 0}
    for t in range(40):
        x, now = _tick_inputs(rng, t, C, tick_ms)
        key = jax.random.PRNGKey(int(rng.integers(0, 2 ** 31)))
        ref_e, ref_pen, ref_ev = ref_adv(
            ref_e, now=jnp.float32(now), key=key,
            **{k: jnp.asarray(v) for k, v in x.items()})
        e, pen, ev = tiers.advance_economy(
            p, e, tick_ms=tick_ms, now=float(now),
            key=convert.key_from_data(np.asarray(key), CPU),
            **{k: torch.as_tensor(v) for k, v in x.items()})
        _assert_econ_equal(e, ref_e, f"tick {t}")
        np.testing.assert_allclose(pen.numpy(), np.asarray(ref_pen),
                                   atol=1e-5, rtol=0)
        assert {k: int(v) for k, v in ev.items()} == \
            {k: int(v) for k, v in ref_ev.items()}, t
        for k in seen:
            seen[k] += int(ev[k])
    if profile == "stress":
        assert seen["cold_starts"] > 0 and seen["preemptions"] > 0
    if profile == "local":
        assert int(e.spend_uusd.sum()) == int(np.asarray(
            ref_e.spend_uusd).sum())


@pytest.mark.parametrize("seed,offset", [(0, 0), (11, 65_536 - 4096),
                                         (2 ** 31 - 1, 123)])
def test_preemption_draws_match_reference(seed, offset):
    """The per-cell ``uniform(fold_in(key, cid), (3,))`` draws at 4,096
    cells, bit for bit."""
    key = jax.random.PRNGKey(seed)
    cids = np.arange(4096, dtype=np.int32) + offset
    want = np.asarray(jax.vmap(lambda c: jax.random.uniform(
        jax.random.fold_in(key, c), (3,)))(jnp.asarray(cids)))
    k = convert.key_from_data(np.asarray(key), CPU)
    got = rnd.uniform_at(rnd.fold_in(k, torch.as_tensor(cids))[:, None, :],
                         torch.arange(3)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("profile", ("serverless", "stress"))
def test_init_and_ticks_to_warm_match_reference(profile):
    ref_p, p = _profiles(profile)
    _assert_econ_equal(tiers.init_economy(p, 6, N_MAX, CPU),
                       ref_tiers.init_economy(ref_p, 6, N_MAX), "init")
    rng = np.random.default_rng(1)
    ref_e = ref_tiers.init_economy(ref_p, 64, N_MAX)._replace(
        tier_state=jnp.asarray(rng.integers(0, 3, (64, 3)), jnp.int32),
        warmup_left=jnp.asarray(rng.integers(0, 9, (64, 3)), jnp.int32))
    np.testing.assert_array_equal(
        tiers.ticks_to_warm(p, convert.tier_economy_state(ref_e, CPU)),
        np.asarray(ref_tiers.ticks_to_warm(ref_p, ref_e)))
    a = np.arange(-1, 10, dtype=np.int32)
    np.testing.assert_array_equal(tiers.tier_of_action(torch.as_tensor(a)),
                                  np.asarray(ref_tiers.tier_of_action(a)))


def test_profile_validation_matches_reference():
    for mod in (ref_tiers, tiers):
        with pytest.raises(TypeError, match="3-tuple"):
            mod.EconomyProfile(**dict(STRESS, price_per_req_s=[0.0] * 3))
        with pytest.raises(TypeError, match="plain"):
            mod.EconomyProfile(**dict(STRESS, preempt_prob=(0.0, None, 0.0)))
        with pytest.raises(ValueError, match="unknown economy profile"):
            mod.builtin_profile("reserved")
    assert tiers.PROFILE_NAMES == ref_tiers.PROFILE_NAMES
    for name in tiers.PROFILE_NAMES:
        assert (tiers.builtin_profile(name).route_price()
                == ref_tiers.builtin_profile(name).route_price())


# ----------------------------------------------------------- observations
@pytest.mark.parametrize("spec,with_state,profile", [
    ("economy", True, "spot"), ("full_economy", True, "spot"),
    ("full_economy", True, "stress"), ("economy", False, "spot"),
    ("full_economy", False, "spot")])
def test_economy_observation_matches_reference(spec, with_state, profile):
    """The env's observation with the economy block fed from a random
    economy state (``FleetConfig.economy`` set), and the neutral block
    (every tier warm, instant, free) when the env has no economy.  The
    stress profile's 1e-3 $/req-s edge price is one whose feature the
    reference's compiled observe rounds apart from a division."""
    cells = 48
    ref_p, p = _profiles(profile)
    eco = dict(economy=ref_p) if with_state else {}
    ref_scn = ref_random_fleet(jax.random.PRNGKey(5), cells, n_max=N_MAX,
                               cells_per_edge=4)
    ref_env = ref_make_fleet_env(RefFleetConfig(
        n_max=N_MAX, obs_spec=spec, shared_cloud=True, shared_edge=True,
        **eco))
    env = make_fleet_env(FleetConfig(
        n_max=N_MAX, obs_spec=spec, shared_cloud=True, shared_edge=True,
        **({"economy": p} if with_state else {})))
    ref_st = ref_env.init(jax.random.PRNGKey(6), ref_scn)
    acts = np.random.default_rng(7).integers(0, 10, (2, cells))
    for a in acts:
        ref_st, *_ = ref_env.step(ref_scn, ref_st, jnp.asarray(a, jnp.int32))
    if with_state:
        rng = np.random.default_rng(8)
        ref_st = ref_st._replace(econ=ref_st.econ._replace(
            tier_state=jnp.asarray(rng.integers(0, 3, (cells, 3)),
                                   jnp.int32),
            warmup_left=jnp.asarray(rng.integers(0, 90, (cells, 3)),
                                    jnp.int32)))
    want = np.asarray(ref_env.observe(ref_scn, ref_st))
    got = env.observe(convert.fleet_scenario(ref_scn, CPU),
                      convert.fleet_state(ref_st, CPU)).numpy()
    assert got.shape == want.shape == (cells, make_spec(spec, N_MAX).dim)
    # the economy block bit for bit; the others within the env's 1e-5
    e = make_spec(spec, N_MAX).block_slices()["economy"]
    np.testing.assert_array_equal(got[:, e], want[:, e])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if not with_state:
        np.testing.assert_array_equal(got[:, e.start::3], 1.0)
    else:
        assert len(np.unique(got[:, e])) > 5


@pytest.mark.parametrize("profile", ("spot", "serverless"))
def test_env_init_seeds_and_carries_the_economy(profile):
    """``init`` seeds the reference's economy state; ``transition``
    carries it unchanged (the engine advances it)."""
    ref_p, p = _profiles(profile)
    ref_scn = ref_random_fleet(jax.random.PRNGKey(1), 8, n_max=N_MAX)
    ref_env = ref_make_fleet_env(RefFleetConfig(n_max=N_MAX,
                                                obs_spec="economy",
                                                economy=ref_p))
    env = make_fleet_env(FleetConfig(n_max=N_MAX, obs_spec="economy",
                                     economy=p))
    scn = convert.fleet_scenario(ref_scn, CPU)
    key = jax.random.PRNGKey(2)
    ref_st = ref_env.init(key, ref_scn)
    st = env.init(convert.key_from_data(np.asarray(key), CPU), scn)
    _assert_econ_equal(st.econ, ref_st.econ, "init")
    econ = st.econ._replace(warmup_left=st.econ.warmup_left + 3)
    st2, *_ = env.transition(scn, st._replace(econ=econ),
                             torch.zeros(8, dtype=torch.int32))
    assert st2.econ is econ


# ----------------------------------------------------------------- router
def _random_economy_obs(rng, n_obs, spec_name, profile):
    """(obs float32 (n, D), constraint, n_users, latency_target) in the
    encoders' layout: mid-round cursors, committed accuracy from the
    menu, occupancies on the 9-level grid, every tier state with its
    ticks-to-warm."""
    spec = make_spec(spec_name, N_MAX)
    acc = np.array([89.9, 88.2, 84.9, 74.2, 88.9, 87.0, 83.2, 72.8],
                   np.float32)
    n = rng.integers(1, N_MAX + 1, n_obs)
    u = rng.integers(0, n)
    cols = [np.eye(N_MAX, dtype=np.float32)[u]]
    cols += [(rng.random((n_obs, N_MAX)) < 0.3).astype(np.float32)
             for _ in range(3)]
    weak_e = (rng.random(n_obs) < 0.3).astype(np.float32)
    for _ in range(2):   # edge, cloud: occupancy, busy flag, weak edge
        cols += [(rng.integers(0, 9, n_obs) / 8.0)[:, None],
                 (rng.random(n_obs) < 0.2)[:, None], weak_e[:, None]]
    committed = np.array([acc[rng.integers(0, 8, k)].sum() for k in u])
    cols += [(committed / (100.0 * n))[:, None], (u / n)[:, None]]
    if "cloud_load" in spec.blocks:
        cols += [rng.random((n_obs, 2))]
    constraint = rng.choice([72.8, 80.0, 85.0, 89.0, 89.9], n_obs)
    target = rng.choice([150.0, 250.0, 400.0, 600.0, 800.0], n_obs)
    if "constraint" in spec.blocks:
        cols += [np.stack([constraint / 100.0, target / 1000.0], -1)]
    state = rng.integers(0, 3, (n_obs, 3))
    cs = np.asarray(profile.cold_start_ticks)
    ticks = np.where(state == 0, cs[None, :],
                     np.where(state == 1, rng.integers(1, 21, (n_obs, 3)),
                              0))
    price = np.minimum(np.asarray(profile.route_price()), 0.01) / 0.01
    eco = np.stack([state / 2.0, np.minimum(ticks, 64) / 64.0,
                    np.broadcast_to(price, (n_obs, 3))], -1)
    cols += [eco.reshape(n_obs, 9)]
    obs = np.concatenate([np.asarray(c, np.float64).reshape(n_obs, -1)
                          for c in cols], -1).astype(np.float32)
    assert obs.shape == (n_obs, spec.dim)
    f32 = lambda v: np.asarray(v, np.float32)
    return obs, f32(constraint), f32(n), f32(target)


@pytest.mark.parametrize("profile,spec,lam", [
    ("spot", "full_economy", None), ("serverless", "full_economy", None),
    ("spot", "economy", None), ("stress", "full_economy", None),
    ("serverless", "economy", (200.0, 1.0))])
def test_cost_greedy_actions_match_reference(profile, spec, lam):
    """Identical actions on 2,000 random economy observations."""
    ref_p, p = _profiles(profile)
    kw = {} if lam is None else dict(lam_cost=lam[0], lam_energy=lam[1])
    obs, constraint, n, target = _random_economy_obs(
        np.random.default_rng(len(profile) + len(spec)), 2000, spec, p)
    ref_pol = ref_routing.cost_greedy_policy(ref_make_spec(spec, N_MAX),
                                             ref_p, **kw)
    pol = routing.cost_greedy_policy(make_spec(spec, N_MAX), p, **kw)
    want = np.asarray(ref_pol.act(
        {"constraint": jnp.asarray(constraint), "n_users": jnp.asarray(n),
         "latency_target": jnp.asarray(target)}, jnp.asarray(obs), None))
    got = pol.act({"constraint": torch.as_tensor(constraint),
                   "n_users": torch.as_tensor(n),
                   "latency_target": torch.as_tensor(target)},
                  torch.as_tensor(obs), None)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) >= 3  # the router does route


def test_cost_greedy_needs_an_economy_spec():
    for spec in ("full", "base"):
        with pytest.raises(ValueError, match="economy"):
            routing.cost_greedy_policy(make_spec(spec, N_MAX),
                                       tiers.builtin_profile("spot"))


@pytest.mark.parametrize("scenario,n,constraint,profile", [
    ("A", 3, 85.0, "spot"), ("B", 3, 89.9, "serverless"),
    ("C", 5, 80.0, "spot"), ("D", 5, 89.0, "serverless"),
    ("B", 5, 72.8, "stress")])
def test_solve_optimal_economy_matches_reference(scenario, n, constraint,
                                                 profile):
    ref_p, p = _profiles(profile)
    want = ref_routing.solve_optimal_economy(REF_SCENARIOS[scenario],
                                             constraint, n, ref_p)
    got = routing.solve_optimal_economy(SCENARIOS[scenario], constraint, n,
                                        p)
    np.testing.assert_array_equal(got["actions"], np.asarray(want["actions"]))
    for k in ("cost_usd", "energy_j", "art", "acc", "objective"):
        assert abs(got[k] - want[k]) <= 1e-9 * max(1.0, abs(want[k])), k
    assert routing.economy_tier_weights(p) == \
        ref_routing.economy_tier_weights(ref_p)


# ----------------------------------------------------------------- serving
def _serve_both(profile, kind, *, cells=24, rounds=10, seed=3, quiet=False,
                shared=True, spec="full_economy", tick_ms=50.0,
                queue_cap=64):
    ref_p, p = _profiles(profile)
    ref_scn = ref_random_fleet(jax.random.PRNGKey(seed), cells, n_max=N_MAX,
                               cells_per_edge=4 if shared else 1)
    kw = dict(n_max=N_MAX, obs_spec=spec, quiet=quiet, shared_cloud=shared,
              shared_edge=shared, tick_ms=tick_ms, queue_cap=queue_cap)
    ref_cfg = RefServeConfig(economy=ref_p, **kw)
    horizon = rounds * ref_cfg.round_ms
    stream = ref_poisson_stream(jax.random.PRNGKey(seed + 1), ref_scn,
                                horizon, rate=3.0, round_ms=ref_cfg.round_ms,
                                epoch_ms=horizon / 2)
    ref_spec, port_spec = ref_make_spec(spec, N_MAX), make_spec(spec, N_MAX)
    if kind == "cost_greedy":
        ref_pol = ref_routing.cost_greedy_policy(ref_spec, ref_p,
                                                 tick_ms=tick_ms)
        pol = routing.cost_greedy_policy(port_spec, p, tick_ms=tick_ms)
    elif kind == "dqn":   # a network reading the economy block
        ref_pol = ref_adapters.dqn_policy(ref_spec, hidden=(32,))
        pol = adapters.dqn_policy(port_spec, hidden=(32,))
    else:
        ref_pol = ref_adapters.heuristic_greedy_policy(ref_spec)
        pol = adapters.heuristic_greedy_policy(port_spec)
    ref_key = jax.random.PRNGKey(seed + 2)
    ref_params = ref_pol.init(jax.random.PRNGKey(seed + 3))
    params = (convert.policy_params(jax.tree.map(np.asarray, ref_params),
                                    CPU) if kind == "dqn"
              else pol.init(0, CPU))
    ref = ref_serve_stream(ref_pol, ref_params, ref_scn, stream,
                           ref_cfg, key=ref_key)
    rep = serve_stream(pol, params,
                       convert.fleet_scenario(ref_scn, CPU),
                       convert.request_stream(stream),
                       ServeConfig(economy=p, **kw),
                       key=convert.key_from_data(np.asarray(ref_key), CPU),
                       device=CPU)
    return rep, ref


def _assert_records_match(rep, ref):
    for k in EXACT:
        np.testing.assert_array_equal(rep["records"][k],
                                      np.asarray(ref["records"][k]), k)
    for k in CLOSE:
        np.testing.assert_allclose(rep["records"][k],
                                   np.asarray(ref["records"][k]),
                                   atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("profile,kind,kw", [
    ("spot", "cost_greedy", {}), ("serverless", "cost_greedy", {}),
    ("stress", "cost_greedy", {}), ("serverless", "greedy", {}),
    ("stress", "dqn", {}),
    ("stress", "cost_greedy", dict(tick_ms=40.0, queue_cap=8, quiet=True,
                                   shared=False, spec="economy"))])
def test_serve_economy_matches_reference(profile, kind, kw):
    """The serving tick under each profile, background on and both
    couplings (and once quiet, uncoupled, at a 40 ms tick with small
    rings): integer records identical, float records within 1e-5, and
    ``report["economy"]`` equal (its four billing integers exactly)."""
    rep, ref = _serve_both(profile, kind, **kw)
    _assert_records_match(rep, ref)
    assert rep["served_requests"] == ref["served_requests"] > 0
    assert rep["economy"] == ref["economy"]
    eco = rep["economy"]
    assert eco["spend_uusd_total"] > 0 and eco["energy_j_total"] > 0
    if profile == "stress":
        assert eco["cold_starts"] > 0 and eco["preemptions"] > 0


def test_local_profile_matches_no_economy():
    """``local`` (always warm, free) schedules byte-identically to no
    economy on a quiet background with the greedy policy: records equal,
    no spend, energy metered (the reference's own bar)."""
    n_max, cells = 3, 4
    scn = random_fleet(rnd.PRNGKey(21, CPU), cells, n_max=n_max)
    stream = poisson_request_stream(rnd.PRNGKey(22, CPU), scn, 2000.0,
                                    rate=2.0, round_ms=n_max * 50.0)
    pol = adapters.heuristic_greedy_policy(make_spec("base", n_max))
    params = pol.init(0, CPU)
    off = serve_stream(pol, params, scn, stream,
                       ServeConfig(n_max=n_max, quiet=True),
                       key=rnd.PRNGKey(1, CPU), device=CPU)
    loc = serve_stream(pol, params, scn, stream,
                       ServeConfig(n_max=n_max, quiet=True,
                                   economy=tiers.builtin_profile("local")),
                       key=rnd.PRNGKey(1, CPU), device=CPU)
    assert "economy" not in off
    assert off["served_requests"] == loc["served_requests"] > 0
    for k, v in off["records"].items():
        np.testing.assert_array_equal(v, loc["records"][k], k)
    assert off["mean_art_ms"] == loc["mean_art_ms"]
    eco = loc["economy"]
    assert eco["profile"] == "local" and eco["spend_uusd_total"] == 0
    assert eco["cost_usd_total"] == 0.0 and eco["cost_per_1k_requests"] == 0.0
    assert eco["cold_starts"] == 0 and eco["preemptions"] == 0
    assert eco["energy_j_total"] > 0.0 and eco["joules_per_request"] > 0.0


def test_cost_greedy_free_and_warm_is_greedy():
    """With λ_c = λ_e = 0 under ``local`` the router is the latency-greedy
    baseline: identical records on the same stream."""
    n_max, cells = 3, 4
    local = tiers.builtin_profile("local")
    cfg = ServeConfig(n_max=n_max, obs_spec="economy", quiet=True,
                      economy=local)
    spec = cfg.fleet().spec()
    scn = random_fleet(rnd.PRNGKey(41, CPU), cells, n_max=n_max)
    stream = poisson_request_stream(rnd.PRNGKey(42, CPU), scn, 2500.0,
                                    rate=2.0, round_ms=cfg.round_ms)
    g = adapters.heuristic_greedy_policy(spec)
    c = routing.cost_greedy_policy(spec, local, lam_cost=0.0,
                                   lam_energy=0.0, tick_ms=cfg.tick_ms)
    rg = serve_stream(g, g.init(0, CPU), scn, stream, cfg,
                      key=rnd.PRNGKey(2, CPU), device=CPU)
    rc = serve_stream(c, c.init(0, CPU), scn, stream, cfg,
                      key=rnd.PRNGKey(2, CPU), device=CPU)
    assert rg["served_requests"] == rc["served_requests"] > 0
    for k, v in rg["records"].items():
        np.testing.assert_array_equal(v, rc["records"][k], k)
    assert rg["slo_attainment"] == rc["slo_attainment"]


# ----------------------------------------------------------------- bundles
def test_cost_greedy_bundle_crosses_both_ways(tmp_path):
    meta = {"economy_profile": "spot", "lam_cost": 300.0, "tick_ms": 40.0}
    ref_pol = ref_routing.cost_greedy_policy(
        ref_make_spec("full_economy", N_MAX), ref_tiers.builtin_profile("spot"))
    ref_path = str(tmp_path / "ref.bundle.msgpack")
    ref_bundle.save_bundle(ref_path, ref_bundle.PolicyBundle(
        "cost_greedy", "full_economy", N_MAX, ref_pol.init(None), meta=meta))
    pol, params = bundle.policy_from_bundle(bundle.load_bundle(ref_path), CPU)
    assert pol.kind == "cost_greedy"
    assert set(params) == {"constraint", "n_users", "latency_target"}

    path = str(tmp_path / "port.bundle.msgpack")
    port_pol = routing.cost_greedy_policy(make_spec("economy", N_MAX),
                                          tiers.builtin_profile("serverless"))
    bundle.save_bundle(path, bundle.PolicyBundle(
        "cost_greedy", "economy", N_MAX, port_pol.init(0, CPU),
        meta={"economy_profile": "serverless"}))
    b = ref_bundle.load_bundle(path, expect_spec="economy")
    r_pol, r_params = ref_bundle.policy_from_bundle(b)
    assert r_pol.kind == "cost_greedy" and b.meta["economy_profile"] == \
        "serverless"
    # the same router on both sides: the reference's bundle, loaded by
    # the port, acts as the reference's policy with the bundle's meta
    obs, constraint, n, target = _random_economy_obs(
        np.random.default_rng(3), 300, "full_economy",
        tiers.builtin_profile("spot"))
    want = np.asarray(ref_routing.cost_greedy_policy(
        ref_make_spec("full_economy", N_MAX),
        ref_tiers.builtin_profile("spot"), lam_cost=300.0,
        tick_ms=40.0).act({"constraint": jnp.asarray(constraint),
                           "n_users": jnp.asarray(n),
                           "latency_target": jnp.asarray(target)},
                          jnp.asarray(obs), None))
    got = pol.act({"constraint": torch.as_tensor(constraint),
                   "n_users": torch.as_tensor(n),
                   "latency_target": torch.as_tensor(target)},
                  torch.as_tensor(obs), None)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cost_greedy_bundle_validation(tmp_path):
    path = str(tmp_path / "x")
    with pytest.raises(bundle.SpecMismatchError, match="economy"):
        bundle.save_bundle(path, bundle.PolicyBundle(
            "cost_greedy", "full", N_MAX, {},
            meta={"economy_profile": "spot"}))
    with pytest.raises(bundle.BundleError, match="economy_profile"):
        bundle.save_bundle(path, bundle.PolicyBundle(
            "cost_greedy", "economy", N_MAX, {}))
    # a bundle without its profile record: both packages refuse its load
    ref_ckpt.save(path, {"format": bundle.BUNDLE_FORMAT, "version": 1,
                    "kind": "cost_greedy", "obs_spec": "economy",
                    "n_max": N_MAX, "params": {}, "meta": {}})
    for load in (bundle.load_bundle, ref_bundle.load_bundle):
        with pytest.raises(ValueError, match="economy_profile"):
            load(path)


# --------------------------------------------------------------------- CLI
def test_cli_economy_rejects_round_replay(tmp_path):
    with pytest.raises(SystemExit, match="round-replay"):
        serve_fleet.main(["--greedy", "--economy", "spot", "--round-replay",
                          "--device", "cpu"])
    with pytest.raises(SystemExit):
        serve_fleet.main(["--greedy", "--economy", "reserved", "--device",
                          "cpu"])


def test_cli_economy_matches_reference_cli(tmp_path, capsys):
    """``serve_fleet --economy spot`` on a ``cost_greedy`` bundle serves
    what the reference CLI's ``serve_bundle`` serves for the same seed:
    records, report figures and ``report["economy"]``; the config records
    the economy and the tick."""
    path = str(tmp_path / "cg.bundle.msgpack")
    pol = routing.cost_greedy_policy(make_spec("full_economy", N_MAX),
                                     tiers.builtin_profile("spot"))
    bundle.save_bundle(path, bundle.PolicyBundle(
        "cost_greedy", "full_economy", N_MAX, pol.init(0, CPU),
        meta={"economy_profile": "spot", "shared_cloud": True,
              "shared_edge": True, "cells_per_edge": 4}))
    kw = dict(cells=16, rounds=6, epochs=2, seed=5)
    ref = ref_serve_bundle(path, economy="spot", verbose=False, **kw)
    out = str(tmp_path / "rep.json")
    rep = serve_fleet.main(["--bundle", path, "--economy", "spot",
                            "--cells", "16", "--rounds", "6", "--epochs",
                            "2", "--seed", "5", "--out", out,
                            "--device", "cpu"])
    _assert_records_match(rep, ref)
    assert rep["economy"] == ref["economy"]
    for k in ("served_requests", "dropped_requests", "n_ticks"):
        assert rep[k] == ref[k], k
    for k in ("economy", "tick_ms", "queue_cap", "quiet", "shared_cloud",
              "shared_edge"):
        assert rep["config"][k] == ref["config"][k], k
    text = capsys.readouterr().out
    assert "economy [spot]" in text
    import json
    assert json.load(open(out))["economy"] == rep["economy"]
