"""The port's optimizer, DQN, system model and new draws against the
reference (``repro.training.optimizer``, ``repro.core.dqn``,
``repro.core.system_model``, ``jax.random``), on the same numpy-seeded
inputs.

Bars: Adam / AdamW parameters and moments within 1e-6 over 50 steps; one
DQN and one system-model update from carried weights: loss, td and the
updated parameters within 1e-5; ``normal`` differs from
``jax.random.normal`` in at most 1.5% of values and by at most 5e-7
(PyTorch's float32 ``log1p`` against XLA's), so ``init_mlp_net``'s
weights are within 5e-7; ``randint`` with a tensor bound bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dqn as ref_dqn
from repro.core import networks as ref_networks
from repro.core import system_model as ref_sm
from repro.fleet.env import FleetConfig as RefFleetConfig
from repro.training import optimizer as ref_opt
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.core import dqn, networks, system_model
from repro_torch.fleet.env import FleetConfig
from repro_torch.specs.observation import SPEC_VARIANTS
from repro_torch.training import optimizer as opt

CPU = torch.device("cpu")
D, A = 12, 5


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


def _layers_close(got, want, atol):
    for g, w in zip(got, want, strict=True):
        for k in ("w", "b"):
            np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w[k]),
                                       atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_adam_matches_reference_over_50_steps(name):
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 5), "b": (5,), "v": (3,)}
    params = [{k: rng.normal(size=s).astype(np.float32)
               for k, s in shapes.items()}]
    r_o, p_o = getattr(ref_opt, name)(1e-3), getattr(opt, name)(1e-3)
    r_p = jax.tree.map(jnp.asarray, params)
    p_p = opt.tree_map(torch.as_tensor, params)
    r_s, p_s = r_o.init(r_p), p_o.init(p_p)
    for _ in range(50):
        # gradients over ten orders of magnitude, some near Adam's eps
        g = [{k: (rng.normal(size=s) * 10 ** rng.uniform(-9, 1)).astype(
            np.float32) for k, s in shapes.items()}]
        u, r_s = r_o.update(jax.tree.map(jnp.asarray, g), r_s, r_p)
        r_p = ref_opt.apply_updates(r_p, u)
        u, p_s = p_o.update(opt.tree_map(torch.as_tensor, g), p_s, p_p)
        p_p = opt.apply_updates(p_p, u)
    assert int(p_s.step) == int(r_s.step) == 50
    for got, want in ((p_p, r_p), (p_s.mu, r_s.mu), (p_s.nu, r_s.nu)):
        for k in shapes:
            np.testing.assert_allclose(got[0][k].numpy(),
                                       np.asarray(want[0][k]), atol=1e-6,
                                       rtol=0)


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(1)
    tree = [{"w": rng.normal(size=(4, 3)).astype(np.float32) * 5,
             "b": rng.normal(size=3).astype(np.float32)}]
    r_g, r_n = ref_opt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree),
                                           2.0)
    p_g, p_n = opt.clip_by_global_norm(opt.tree_map(torch.as_tensor, tree),
                                       2.0)
    np.testing.assert_allclose(float(p_n), float(r_n), rtol=1e-6)
    _layers_close([{k: v.numpy() for k, v in p_g[0].items()}], r_g, 1e-6)


def test_normal_matches_jax_random_normal():
    """Bit-equal uniforms through XLA's erf_inv polynomials: only the
    two libraries' float32 log1p round apart."""
    for seed, shape in ((0, (400_000,)), (3, (7, 9)), (11, (128, 128))):
        rk, pk = _key(seed)
        want = np.asarray(jax.random.normal(rk, shape))
        got = rnd.normal(pk, shape).numpy()
        assert got.dtype == np.float32 and got.shape == shape
        diff = np.abs(got.astype(np.float64) - want)
        assert (diff > 0).mean() <= 0.015, (diff > 0).mean()
        assert diff.max() <= 5e-7, diff.max()
    # the 400,000 draws: about 1% differ (measured 0.97%)
    rk, pk = _key(0)
    d = rnd.normal(pk, (400_000,)).numpy() != np.asarray(
        jax.random.normal(rk, (400_000,)))
    assert 0.005 <= d.mean() <= 0.015


def test_randint_with_a_tensor_maxval_is_bit_equal():
    for seed, hi in ((0, 1), (1, 2), (2, 7), (3, 4096), (4, 0), (5, 65537)):
        rk, pk = _key(seed)
        want = np.asarray(jax.random.randint(
            rk, (257,), 0, jnp.maximum(jnp.int32(hi), 1)))
        got = rnd.randint(pk, (257,), 0,
                          torch.tensor(hi, dtype=torch.int32).clamp(min=1))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_init_mlp_net_matches_reference():
    rk, pk = _key(9)
    sizes = (D, 32, 16, A)
    want = ref_networks.init_mlp_net(rk, sizes)
    net = networks.init_mlp_net(pk, sizes)
    assert net.sizes == sizes
    _layers_close(net.to_layers(), want, 5e-7)


def _batch(rng, n=64, dim=D):
    return (rng.normal(size=(n, dim)).astype(np.float32),
            rng.integers(0, A, n).astype(np.int32),
            rng.normal(size=n).astype(np.float32),
            rng.normal(size=(n, dim)).astype(np.float32),
            (rng.random(n) < 0.3).astype(np.float32))


def _carry_dqn(r_state):
    """The reference's DQNState as the port's (weights carried over)."""
    mlp = lambda layers: convert.mlp_from_layers(
        [{k: np.array(v) for k, v in l.items()} for l in layers], CPU)
    r_opt = r_state.opt_state
    flat = lambda t: ([torch.as_tensor(np.array(l["w"])) for l in t]
                      + [torch.as_tensor(np.array(l["b"])) for l in t])
    return dqn.DQNState(mlp(r_state.params),
                        mlp(r_state.target_params).requires_grad_(False),
                        opt.AdamState(torch.as_tensor(np.array(r_opt.step)),
                                      flat(r_opt.mu), flat(r_opt.nu)),
                        torch.as_tensor(np.array(r_state.step)))


def test_dqn_update_matches_reference():
    rng = np.random.default_rng(5)
    r_init, _, r_update, r_sync = ref_dqn.make_dqn(D, A, hidden=(32, 32))
    _, q_values, update, sync = dqn.make_dqn(D, A, hidden=(32, 32))
    rk, _ = _key(2)
    r_state = r_init(rk)
    # a target apart from the online net: one update, then no sync
    b0 = _batch(rng)
    w0 = rng.random(64).astype(np.float32)
    r_state, _, _ = r_update(r_state, tuple(map(jnp.asarray, b0)),
                             jnp.asarray(w0))
    state = _carry_dqn(r_state)
    b, w = _batch(rng), rng.random(64).astype(np.float32)
    r_state2, r_loss, r_td = r_update(r_state, tuple(map(jnp.asarray, b)),
                                      jnp.asarray(w))
    state2, loss, td = update(state, tuple(map(torch.as_tensor, b)),
                              torch.as_tensor(w))
    np.testing.assert_allclose(float(loss), float(r_loss), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(td.numpy(), np.asarray(r_td), atol=1e-5,
                               rtol=0)
    _layers_close(state2.params.to_layers(), r_state2.params, 1e-5)
    assert int(state2.step) == int(r_state2.step) == 2
    assert int(state2.opt_state.step) == 2
    np.testing.assert_allclose(
        q_values(state2.params, torch.as_tensor(b[0])).numpy(),
        np.asarray(ref_networks.apply_mlp_net(r_state2.params,
                                              jnp.asarray(b[0]))),
        atol=1e-5, rtol=0)
    # sync_target copies the online weights
    sync(state2)
    _layers_close(state2.target_params.to_layers(),
                  r_sync(r_state2).target_params, 1e-5)


def test_dqn_update_not_applied_keeps_the_state():
    """``apply`` false (a buffer short of a batch): parameters, moments
    and counters stay, as the reference's ``where`` keeps them."""
    rng = np.random.default_rng(6)
    init, _, update, _ = dqn.make_dqn(D, A, hidden=(16,))
    state = init(_key(1)[1])
    before = [p.detach().clone() for p in state.params.parameters()]
    b, w = _batch(rng), rng.random(64).astype(np.float32)
    state2, loss, _ = update(state, tuple(map(torch.as_tensor, b)),
                             torch.as_tensor(w), apply=torch.tensor(False))
    for p, q in zip(state2.params.parameters(), before):
        assert torch.equal(p, q)
    assert int(state2.step) == 0 and int(state2.opt_state.step) == 0
    assert all(int(torch.count_nonzero(m)) == 0 for m in state2.opt_state.mu)
    assert torch.isfinite(loss)


def test_system_model_update_and_predictions_match_reference():
    rng = np.random.default_rng(7)
    r_init, r_predict, r_all, r_update = ref_sm.make_system_model(
        D, A, lr=2e-3)
    _, predict, predict_all, update = system_model.make_system_model(
        D, A, lr=2e-3)
    r_state = r_init(_key(3)[0])
    mlp = convert.mlp_from_layers(
        [{k: np.array(v) for k, v in l.items()} for l in r_state.params],
        CPU)
    state = system_model.SystemModelState(
        mlp, opt.adam(2e-3).init(list(mlp.parameters())),
        torch.zeros((), dtype=torch.int32))
    b = _batch(rng)
    r_state2, r_loss = r_update(r_state, tuple(map(jnp.asarray, b)))
    state2, loss = update(state, tuple(map(torch.as_tensor, b)))
    np.testing.assert_allclose(float(loss), float(r_loss), atol=1e-5,
                               rtol=0)
    _layers_close(state2.params.to_layers(), r_state2.params, 1e-5)
    s = rng.normal(size=(9, D)).astype(np.float32)
    a = rng.integers(0, A, 9).astype(np.int32)
    for got, want in zip(predict(state2.params, torch.as_tensor(s),
                                 torch.as_tensor(a)),
                         r_predict(r_state2.params, jnp.asarray(s),
                                   jnp.asarray(a))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
    # every action of a batch of states in one product: the reference's
    # per-state function mapped over the batch
    r_hat, s2_hat = predict_all(state2.params, torch.as_tensor(s))
    w_r, w_s2 = jax.vmap(r_all, in_axes=(None, 0))(r_state2.params,
                                                   jnp.asarray(s))
    assert r_hat.shape == (9, A) and s2_hat.shape == (9, A, D)
    np.testing.assert_allclose(r_hat.numpy(), np.asarray(w_r), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(s2_hat.numpy(), np.asarray(w_s2), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("n_max", [3, 5, 8])
def test_fleet_config_state_dim_matches_reference(n_max):
    for name in SPEC_VARIANTS:
        assert FleetConfig(n_max=n_max, obs_spec=name).state_dim == \
            RefFleetConfig(n_max=n_max, obs_spec=name).state_dim
    for name in ("economy", "full_economy"):  # 9 economy features on top
        assert FleetConfig(n_max=n_max, obs_spec=name).state_dim == \
            RefFleetConfig(n_max=n_max, obs_spec=name).state_dim == \
            RefFleetConfig(n_max=n_max,
                           obs_spec=name.replace("economy", "base")
                           .replace("full_base", "full")).state_dim + 9
