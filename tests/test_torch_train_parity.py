"""One LM train step of the port against the JAX reference's, per
architecture, on the CPU.

For every config of ``ARCH_IDS`` at smoke size, the reference's
``init_train_state`` (an ``sgd`` state) is carried into the port with
``convert.lm_train_state``, and both packages take one ``sgd`` step of
``make_train_step`` on the same batch (the reference's, carried across;
``remat=False`` on the reference side, which changes no value): loss,
CE, aux and the gradient norm within 1e-5 relative, every parameter
within 1e-6 after the step, and every gradient leaf of ``lm_loss``
within 1e-5 of its largest magnitude (zamba2's within 1e-4, see
``GRAD_TOL``).  The port's gradients run through
``FlashAttention``'s plain backward and the plain WKV6 and SSD versions,
which differentiate on the CPU.

Parity goes through ``sgd`` because Adam's first step moves each weight
by about ±lr whatever the gradient's size, so a gradient near zero
could flip its sign and the weights differ by 2·lr;
``tests/test_torch_train.py`` holds Adam to the reference on identical
gradients.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.configs.shapes import make_batch as jmake_batch
from repro.data.pipeline import batch_for_config as jbatch_for_config
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_step as ts

CPU = torch.device("cpu")
LR = 0.05
# zamba2's Mamba2 gradients (the SSD's decay and conv leaves, and through
# them the embedding) are not defined to 1e-5 in float32: the reference's
# own float32 gradients lie up to 5.9e-5 of a leaf's largest magnitude
# from its float64 ones at this shape, and the port's up to 5.3e-5
# (measure/train_grad_f64_cpu.py); the two packages lie 3e-5 apart
GRAD_TOL = {"zamba2-1.2b": 1e-4}


def reference_batch(jcfg, b, s, seed=0):
    """The reference's training batch: the synthetic corpus for text
    configs, ``make_batch`` for codebook and vision ones (whose S counts
    the patch positions)."""
    if jcfg.num_codebooks or jcfg.num_patch_positions:
        return jmake_batch(jcfg, jax.random.PRNGKey(seed), b,
                           s + jcfg.num_patch_positions)
    return jbatch_for_config(jcfg, seed, b, s)


def torch_batch(batch):
    return {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_sgd_step_matches_reference(arch):
    jcfg, cfg = jget_smoke(arch), get_smoke_config(arch)
    jo = jopt.sgd(LR)
    jstate = jts.init_train_state(jax.random.PRNGKey(0), jcfg, jo)
    jbatch = reference_batch(jcfg, 2, 24)
    jstep = jts.make_train_step(jcfg, jo, remat=False)

    @jax.jit
    def reference(state, batch):
        grads = jax.grad(lambda p: jts.lm_loss(p, jcfg, batch,
                                               remat=False)[0])(state.params)
        return jstep(state, batch), grads

    (jnew, jm), jgrads = reference(jstate, jbatch)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    state = convert.lm_train_state(to_np(jstate), cfg, CPU)
    batch = torch_batch(jbatch)

    # the gradients of lm_loss, leaf by leaf
    tree = ts.param_tree(state.params)
    loss, _ = ts.lm_loss(state.params, cfg, batch, remat=False)
    grads = torch.autograd.grad(loss, list(tree.values()),
                                allow_unused=True, materialize_grads=True)
    want = convert.lm_param_tree(to_np(jgrads), cfg, CPU)
    assert list(want) == list(tree)
    for name, g in zip(tree, grads):
        w = want[name]
        err = float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
        assert err <= GRAD_TOL.get(arch, 1e-5), (name, err)

    new, m = ts.make_train_step(cfg, opt_lib.sgd(LR), remat=False)(state,
                                                                   batch)
    for k in ("loss", "ce", "grad_norm"):
        assert rel(m[k], jm[k]) <= 1e-5, k
    assert abs(float(m["aux"]) - float(jm["aux"])) <= 1e-5 * max(
        1.0, abs(float(jm["aux"])))
    assert (float(m["aux"]) > 0) == (cfg.moe is not None)
    assert int(new.step) == int(jnew.step) == 1
    assert int(new.opt_state.step) == int(jnew.opt_state.step) == 1
    after = convert.lm_param_tree(to_np(jnew.params), cfg, CPU)
    for name, p in ts.param_tree(new.params).items():
        assert float((p.detach() - after[name]).abs().max()) <= 1e-6, name
