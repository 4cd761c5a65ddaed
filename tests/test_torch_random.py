"""The port's threefry keys are bit-equal to ``jax.random`` (default
``jax_threefry_partitionable=True``) at the env's call-site shapes:
``fold_in`` per global cell id, ``split(·, 6)``, and ``uniform`` of
shapes () and (n_max,) (``repro/fleet/env.py`` ``sample_background``)."""
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
