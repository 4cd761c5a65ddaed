"""The port's MoE (``repro_torch.models.moe``) against the JAX reference
on the CPU.

Inputs come from numpy under a seed; the weights are the reference's
``init_moe`` tree, carried across array for array.  Each case holds the
port to the ROADMAP bars: routed ids, ranks, keep flags and buffer slots
identical to the reference's dispatch (``_local_dispatch``, group by
group), y within 1e-5 and the aux loss within 1e-6 of its grouped
single-device path (``_apply_moe_gspmd``).  Cases: prefill-shaped groups,
a decode step at ``capacity_factor = E / k``, a factor of 0.5 that drops,
a shared expert, explicit groups, and an all-zero router where every
probability ties (so the tie order is ``lax.top_k``'s: experts 0 and 1
for every token) and drops are heavy.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import config as jconfig
from repro.models import moe as jmoe
from repro_torch.models import moe
from repro_torch.models.config import MoEConfig

# (name, B, S, D, E, k, F, capacity_factor, groups, shared, zero_router)
CASES = [
    ("prefill", 3, 16, 32, 4, 2, 48, None, None, False, False),
    ("prefill_e8", 2, 24, 40, 8, 2, 24, None, None, False, False),
    ("decode_dropless", 5, 1, 32, 4, 2, 48, 2.0, None, False, False),
    ("dropping", 2, 20, 32, 4, 2, 48, 0.5, None, False, False),
    ("shared_expert", 2, 12, 32, 6, 3, 40, None, None, True, False),
    ("groups_2", 4, 8, 32, 4, 2, 48, None, 2, False, False),
    ("zero_router", 2, 16, 32, 4, 2, 48, None, None, False, True),
]


def _case(seed, b, s, d, e, k, f, shared, zero_router):
    kw = dict(num_experts=e, num_experts_per_tok=k, expert_d_ff=f)
    if shared:
        kw.update(num_shared_experts=1, shared_d_ff=f)
    jcfg, cfg = jconfig.MoEConfig(**kw), MoEConfig(**kw)
    jparams = jax.tree.map(np.asarray, jmoe.init_moe(
        jax.random.PRNGKey(seed), d, jcfg, np.float32))
    if zero_router:
        jparams["router"] = np.zeros_like(jparams["router"])
    params = jax.tree.map(lambda a: torch.as_tensor(np.array(a)), jparams)
    x = np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)
    return jcfg, jparams, cfg, params, x


@pytest.mark.parametrize(
    "name,b,s,d,e,k,f,cf,groups,shared,zero_router", CASES,
    ids=[c[0] for c in CASES])
def test_moe_matches_reference(name, b, s, d, e, k, f, cf, groups, shared,
                               zero_router):
    jcfg, jparams, cfg, params, x = _case(len(name), b, s, d, e, k, f,
                                          shared, zero_router)
    g = groups if groups is not None else (b if s > 1 else 1)
    xg = torch.as_tensor(x).reshape(g, -1, d)
    r = moe.route(params["router"], xg, cfg, cf)
    used_cf = cfg.capacity_factor if cf is None else cf
    for gi in range(g):
        _, cap, (slot, keep, weights, probs, ids) = jmoe._local_dispatch(
            x.reshape(g, -1, d)[gi], jparams["router"], k, e, used_cf,
            np.float32)
        assert r.capacity == cap
        np.testing.assert_array_equal(r.ids[gi].numpy(), np.asarray(ids))
        np.testing.assert_array_equal(r.keep[gi].numpy(), np.asarray(keep))
        np.testing.assert_array_equal(r.slot[gi].numpy(),
                                      gi * e * cap + np.asarray(slot))
        np.testing.assert_array_equal(
            r.pos[gi].numpy(),
            np.asarray(slot) - np.asarray(ids).reshape(-1) * cap)
        np.testing.assert_allclose(r.probs[gi].numpy(), np.asarray(probs),
                                   atol=1e-6)
        np.testing.assert_allclose(r.weights[gi].numpy(),
                                   np.asarray(weights), atol=1e-6)
    jy, jaux = jmoe._apply_moe_gspmd(jparams, x, jcfg, capacity_factor=cf,
                                     groups=groups)
    y, aux = moe.apply_moe(params, torch.as_tensor(x), cfg,
                           capacity_factor=cf, groups=groups)
    assert y.shape == (b, s, d) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    kept = r.keep.numpy()
    if name == "decode_dropless":
        assert kept.all() and r.capacity == b
    if name == "dropping":
        assert not kept.all()
    if zero_router:
        ids = r.ids.numpy()
        assert (ids[..., 0] == 0).all() and (ids[..., 1] == 1).all()
        assert kept.mean() < 0.7  # experts 0 and 1 hold 10 of 16 each


def test_init_moe_tree_matches_the_reference():
    for shared in (False, True):
        kw = dict(num_experts=4, num_experts_per_tok=2, expert_d_ff=24,
                  num_shared_experts=int(shared), shared_d_ff=16 * shared)
        want = jmoe.init_moe(jax.random.PRNGKey(0), 32,
                             jconfig.MoEConfig(**kw), np.float32)
        got = moe.init_moe(torch.Generator().manual_seed(0), 32,
                           MoEConfig(**kw), torch.bfloat16, "cpu")
        shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)
        assert shapes(got) == shapes(want)
        assert got["router"].dtype == torch.float32
        assert got["experts"]["w_gate"].dtype == torch.bfloat16


@pytest.mark.parametrize("tg,k,e,cf", [(33, 2, 4, 1.25), (40, 2, 4, 1.25),
                                       (2048, 2, 8, 1.25), (4, 2, 8, 4.0),
                                       (7, 6, 160, 1.25), (1, 2, 8, 0.01),
                                       (5, 3, 6, 2.0)])
def test_capacity_matches_the_reference(tg, k, e, cf):
    cfg = MoEConfig(num_experts=e, num_experts_per_tok=k)
    _, want, _ = jmoe._local_dispatch(
        np.zeros((tg, 4), np.float32), np.zeros((4, e), np.float32), k, e,
        cf, np.float32)
    assert moe.capacity(tg, cfg, cf) == want
    assert moe.capacity(tg, dataclasses.replace(cfg, capacity_factor=cf)) \
        == moe.capacity(tg, cfg, cf)


def test_groups_must_divide_the_tokens():
    jcfg, jparams, cfg, params, x = _case(0, 3, 5, 16, 4, 2, 8, False,
                                          False)
    with pytest.raises(ValueError, match="groups"):
        moe.apply_moe(params, torch.as_tensor(x), cfg, groups=2)
