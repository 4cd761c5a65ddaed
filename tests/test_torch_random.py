"""The port's threefry keys are bit-equal to ``jax.random`` (default
``jax_threefry_partitionable=True``) at the env's call-site shapes:
``fold_in`` per global cell id, ``split(·, 6)``, and ``uniform`` of
shapes () and (n_max,) (``repro/fleet/env.py`` ``sample_background``);
``randint`` at ``make_batch``'s shapes; and ``gumbel`` / ``categorical``
at ``generate``'s (the Gumbel draws' uniforms bit-equal, their values to
a few float32 ulps, since PyTorch's and XLA's ``log`` round apart);
``uniform`` with ``minval`` / ``maxval`` and ``poisson`` on both of its
branches (Knuth below lam 10, rejection from 10) bit-equal, at the
stream's shapes up to 65,536 cells."""
import jax
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch import random as rnd

CPU = torch.device("cpu")


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def _port_key(jax_key):
    return convert.key_from_data(np.asarray(jax_key), CPU)


@pytest.mark.parametrize("seed", [0, 17, 2**31 - 1, -1, -12345])
def test_prngkey_matches(seed):
    np.testing.assert_array_equal(rnd.PRNGKey(seed, CPU).numpy(),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [1, 2, 6, 33])
def test_split_matches(num):
    for seed in (0, 3, 99):
        k = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(
            rnd.split(_port_key(k), num).numpy(),
            np.asarray(jax.random.split(k, num)))


def test_fold_in_per_cell_matches():
    k = jax.random.split(jax.random.PRNGKey(4))[1]
    cells = np.concatenate([np.arange(300), [2**31 - 1, 65535, 65536]])
    want = jax.vmap(lambda c: jax.random.fold_in(k, c))(cells)
    got = rnd.fold_in(_port_key(k), torch.as_tensor(cells))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        rnd.fold_in(_port_key(k), 7).numpy(),
        np.asarray(jax.random.fold_in(k, 7)))


@pytest.mark.parametrize("shape", [(), (5,), (4, 3), (1000,)])
def test_uniform_matches(shape):
    k = jax.random.fold_in(jax.random.PRNGKey(8), 21)
    np.testing.assert_array_equal(
        _bits(rnd.uniform(_port_key(k), shape).numpy()),
        _bits(jax.random.uniform(k, shape)))


def test_background_draws_match_call_site():
    """``split(fold_in(key, cell), 6)`` then uniforms of shape (n_max,)
    and () per cell, as the env draws them — batched over 64 cells."""
    n_max = 5
    key = jax.random.PRNGKey(31)

    def one_cell(cid):
        ks = jax.random.split(jax.random.fold_in(key, cid), 6)
        return (jax.random.uniform(ks[0], (n_max,)),
                jax.random.uniform(ks[3], ()))

    want_v, want_s = jax.vmap(one_cell)(np.arange(64))
    ks = rnd.split(rnd.fold_in(_port_key(key), torch.arange(64)), 6)
    np.testing.assert_array_equal(_bits(rnd.uniform(ks[:, 0], (n_max,))),
                                  _bits(want_v))
    np.testing.assert_array_equal(_bits(rnd.uniform(ks[:, 3], ())),
                                  _bits(want_s))
    # one batched threefry call gives the same draws
    sub = torch.tensor([0] * n_max + [3])
    idx = torch.tensor(list(range(n_max)) + [0])
    u = rnd.uniform_at(ks[:, sub], idx)
    np.testing.assert_array_equal(_bits(u[:, :n_max]), _bits(want_v))
    np.testing.assert_array_equal(_bits(u[:, n_max]), _bits(want_s))


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rnd.PRNGKey(0)


@pytest.mark.parametrize("shape,lo,hi", [
    ((2, 33), 0, 512), ((4, 2048), 0, 64000), ((3, 7), 0, 65536),
    ((5,), -3, 100_000), ((2, 5), 0, 2**31 - 1), ((9,), 4, 4),
    ((3,), 5, 2)])
def test_randint_matches(shape, lo, hi):
    for seed in (0, 5):
        k = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(
            rnd.randint(_port_key(k), shape, lo, hi).numpy(),
            np.asarray(jax.random.randint(k, shape, lo, hi)))


@pytest.mark.parametrize("shape", [(4, 512), (2, 65536)])
def test_gumbel_and_categorical_match(shape):
    """``generate``'s draws: one key per step, logits (B, V) / T."""
    tiny = np.finfo(np.float32).tiny
    for seed in range(3):
        k = jax.random.split(jax.random.PRNGKey(seed))[1]
        u = rnd.uniform(_port_key(k), shape).clamp_min(tiny).numpy()
        want_u = jax.random.uniform(k, shape, minval=tiny, maxval=1.0)
        np.testing.assert_array_equal(_bits(u), _bits(want_u))
        g = rnd.gumbel(_port_key(k), shape).numpy()
        want_g = np.asarray(jax.random.gumbel(k, shape))
        np.testing.assert_allclose(g, want_g, rtol=4e-7, atol=4e-7)
        logits = np.random.default_rng(seed).standard_normal(shape).astype(
            np.float32) / 0.8
        np.testing.assert_array_equal(
            rnd.categorical(_port_key(k), torch.as_tensor(logits)).numpy(),
            np.asarray(jax.random.categorical(k, logits, axis=-1)))


@pytest.mark.parametrize("lo,hi", [(0.0, 1000.0), (0.0, 250.0),
                                   (-3.0, 2.5), (5.0, 7.0), (-1e3, -2.0)])
def test_uniform_range_matches(lo, hi):
    for seed in (0, 3):
        k = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(
            _bits(rnd.uniform(_port_key(k), (20_000,), lo, hi).numpy()),
            _bits(jax.random.uniform(k, (20_000,), minval=lo, maxval=hi)))


@pytest.mark.parametrize("lam", [0, 0.5, 3, 9.99, 10, 12, 40, 150])
def test_poisson_matches(lam):
    for seed in (0, 1, 2):
        k = jax.random.split(jax.random.PRNGKey(seed))[0]
        got = rnd.poisson(_port_key(k), lam, (4096,)).numpy()
        want = np.asarray(jax.random.poisson(k, lam, (4096,)))
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_poisson_mixes_branches_per_cell():
    """A per-cell rate array across both branches (and lam = 0): each
    element takes its branch's count, and every count depends on the
    whole array's loop."""
    lam = np.random.default_rng(3).uniform(0.0, 30.0, 2000).astype(
        np.float32)
    lam[:50] = 0.0
    lam[50:100] = 10.0
    for seed in (4, 5):
        k = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(
            rnd.poisson(_port_key(k), torch.as_tensor(lam)).numpy(),
            np.asarray(jax.random.poisson(k, lam)))


def test_poisson_at_the_deployment_size():
    """65,536 cells at 3 arrivals per round over 4 rounds: the fleet
    deployment's counts."""
    k = jax.random.split(jax.random.PRNGKey(0))[0]
    mean = np.full(65_536, 12.0)
    np.testing.assert_array_equal(
        rnd.poisson(_port_key(k), torch.as_tensor(mean), (65_536,)).numpy(),
        np.asarray(jax.random.poisson(k, mean, (65_536,))))
