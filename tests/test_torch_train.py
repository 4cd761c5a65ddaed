"""The port's LM training pieces against the JAX reference on the CPU.

Schedules (``constant``, ``cosine_with_warmup``, ``linear_decay``) at 0,
the warm-up's end, mid-way and the end within 1e-7; ``sgd`` (plain and
momentum) and ``adamw`` with a callable rate against the reference's
``optimizer.py`` on identical gradients (moments, steps and updates
within 1e-6 relative); ``cross_entropy``; ``SyntheticLM``,
``batch_for_config`` and ``host_batches`` bit-equal; ``make_train_step``
with ``grad_accum=2`` against the full batch (the reference's
``tests/test_substrate.py::test_grad_accum_matches_full_batch``) and
``remat=True`` against ``remat=False`` (identical); the train CLI on the
CPU; a ``TrainState`` checkpoint round trip; and the multi-card raise
sites, ``grad_specs`` and ``--mesh``.  The per-architecture step parity
is ``tests/test_torch_train_parity.py``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.data import pipeline as jpipe
from repro.training import optimizer as jopt
from repro.training import schedule as jsched
from repro.training import train_step as jts
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_smoke_config
from repro_torch.data import pipeline as pipe
from repro_torch.launch import train as train_cli
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import schedule as sched
from repro_torch.training import train_step as ts

CPU = torch.device("cpu")


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)),
    ("cosine_with_warmup", (3e-4, 20, 100)),
    ("cosine_with_warmup", (1e-3, 0, 7, 0.2)),
    ("linear_decay", (3e-4, 100)),
])
def test_schedules_match(name, args):
    mine, ref = getattr(sched, name)(*args), getattr(jsched, name)(*args)
    for step in (0, 1, 10, 19, 20, 21, 50, 99, 100, 130):
        got = mine(torch.tensor(step, dtype=torch.int32))
        want = ref(jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - float(want)) <= 1e-7, step


def _grad_trees(seed, n=3):
    rng = np.random.default_rng(seed)
    shapes = {"w": (5, 4), "b": (4,), "deep": {"u": (3, 2, 2)}}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(
        np.float32), shapes, is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree.map(lambda s: rng.standard_normal(s).astype(
        np.float32), shapes, is_leaf=lambda x: isinstance(x, tuple))
        for _ in range(n)]
    return params, grads


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.as_tensor(np.array(a)), tree)


def _close(a, b, tol=1e-6):
    for x, y in zip(jax.tree.leaves(jax.tree.map(np.asarray, b)),
                    opt_lib.tree_leaves(a)):
        np.testing.assert_allclose(y.numpy(), x, rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", ["sgd", "sgd_momentum", "adamw_cosine"])
def test_optimizers_match_on_identical_gradients(kind):
    params, grads = _grad_trees(1)
    if kind == "sgd":
        mine, ref = opt_lib.sgd(0.1), jopt.sgd(0.1)
    elif kind == "sgd_momentum":
        mine, ref = opt_lib.sgd(0.1, 0.9), jopt.sgd(0.1, 0.9)
    else:
        mine = opt_lib.adamw(sched.cosine_with_warmup(1e-2, 2, 5))
        ref = jopt.adamw(jsched.cosine_with_warmup(1e-2, 2, 5))
    p, s = _to_torch(params), mine.init(_to_torch(params))
    jp, js = params, ref.init(params)
    for g in grads:
        upd, s = mine.update(_to_torch(g), s, p)
        jupd, js = ref.update(g, js, jp)
        _close(upd, jupd)
        p = opt_lib.apply_updates(p, upd)
        jp = jopt.apply_updates(jp, jupd)
        _close(p, jp)
        assert int(s.step) == int(js.step)
    if kind != "sgd":
        _close(s[1], js[1])


def test_cross_entropy_matches():
    rng = np.random.default_rng(2)
    logits = (4 * rng.standard_normal((2, 3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 3, 7)).astype(np.int32)
    got = ts.cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels))
    want = jts.cross_entropy(logits, labels)
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


def test_synthetic_lm_and_host_batches_bit_equal():
    gen, jgen = pipe.SyntheticLM(64, 9, seed=3), jpipe.SyntheticLM(64, 9,
                                                                  seed=3)
    for step in (0, 5):
        got, want = gen.batch(step, 4), jgen.batch(step, 4)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for arch in ("yi-6b", "musicgen-medium", "qwen2-vl-7b"):
        cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
        seq = 12 + cfg.num_patch_positions
        for host in (0, 1):
            got = list(pipe.host_batches(cfg, global_batch=4, seq_len=seq,
                                         num_steps=2, host_index=host,
                                         num_hosts=2))
            want = list(jpipe.host_batches(jcfg, global_batch=4,
                                           seq_len=seq, num_steps=2,
                                           host_index=host, num_hosts=2))
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                for k in ("tokens", "labels", "positions"):
                    if k in w:
                        np.testing.assert_array_equal(g[k].numpy(),
                                                      np.asarray(w[k]))


def _state(arch, opt):
    """The reference's initial params in the port (``init_train_state``
    with ``params``)."""
    from repro_torch import convert
    jcfg, cfg = jget_smoke(arch), get_smoke_config(arch)
    jparams = jax.tree.map(np.asarray, jts.init_train_state(
        jax.random.PRNGKey(0), jcfg, jopt.sgd(0.1)).params)
    return cfg, ts.init_train_state(cfg, opt, params=convert.lm_params(
        jparams, cfg, CPU))


def test_grad_accum_matches_full_batch():
    """Two microbatches against the whole batch: CE within 1e-5
    relative, parameters within 5e-3 in global norm after an Adam step
    (the reference test's bars), and closer still under sgd."""
    batch = pipe.batch_for_config(get_smoke_config("yi-6b"), 0, 4, 16)
    for opt, bar in ((opt_lib.adam(1e-2), 5e-3), (opt_lib.sgd(0.1), 1e-5)):
        out = []
        for accum in (1, 2):
            cfg, state = _state("yi-6b", opt)
            step = ts.make_train_step(cfg, opt, remat=False,
                                      grad_accum=accum)
            new, m = step(state, batch)
            out.append((ts.param_tree(new.params), m))
        (p1, m1), (p2, m2) = out
        assert float(m1["ce"]) == pytest.approx(float(m2["ce"]), rel=1e-5)
        d = opt_lib.global_norm([(a - b).detach() for a, b in zip(
            p1.values(), p2.values())])
        assert float(d) < bar


def test_remat_changes_nothing():
    out = []
    for remat in (False, True):
        cfg, state = _state("musicgen-medium", opt_lib.sgd(0.1))
        batch = pipe.batch_for_config(cfg, 0, 2, 10)
        new, m = ts.make_train_step(cfg, opt_lib.sgd(0.1),
                                    remat=remat)(state, batch)
        out.append(({k: float(v) for k, v in m.items()},
                    ts.param_tree(new.params)))
    (m1, p1), (m2, p2) = out
    assert m1 == m2
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k


def test_train_cli_on_the_cpu(capsys, tmp_path):
    path = str(tmp_path / "state.msgpack")
    report = train_cli.main(["--arch", "musicgen-medium", "--smoke",
                             "--device", "cpu", "--steps", "3", "--batch",
                             "2", "--seq", "12", "--grad-accum", "2",
                             "--ckpt", path])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("training musicgen-smoke")
    assert out[1].startswith("step    0 loss=")
    assert json.loads(out[-1]) == report
    assert report["device_name"] == "CPU" and len(report["loss"]) == 3
    assert all(np.isfinite(report["loss"])) and report["grad_norm"][0] > 0
    assert report["peak_mem_gb"] is None
    cfg = get_smoke_config("musicgen-medium")
    like = ts.init_train_state(cfg, opt_lib.adamw(3e-4), seed=5,
                               device=CPU)
    back = ckpt.load_train_state(path, like)
    assert int(back.step) == 3 and int(back.opt_state.step) == 3
    # the trained state, written and read back: what a fresh run of the
    # same command computes
    run = train_cli.train("musicgen-medium", smoke=True, steps=3, batch=2,
                          seq=12, grad_accum=2, device="cpu",
                          verbose=False)
    assert run.report["loss"] == report["loss"]
    for name, p in ts.param_tree(run.state.params).items():
        assert torch.equal(p, ts.param_tree(back.params)[name]), name
        assert torch.equal(run.state.opt_state.mu[name],
                           back.opt_state.mu[name])


def test_train_state_checkpoint_round_trip(tmp_path):
    cfg, state = _state("yi-6b", opt_lib.adamw(1e-3))
    batch = pipe.batch_for_config(cfg, 0, 2, 8)
    state, _ = ts.make_train_step(cfg, opt_lib.adamw(1e-3))(state, batch)
    path = str(tmp_path / "s.msgpack")
    ckpt.save_train_state(path, state)
    like = ts.init_train_state(cfg, opt_lib.adamw(1e-3), device=CPU)
    back = ckpt.load_train_state(path, like)
    assert back.params is like.params
    for name, p in ts.param_tree(state.params).items():
        assert torch.equal(p, ts.param_tree(back.params)[name])
        for f in ("mu", "nu"):
            assert torch.equal(getattr(state.opt_state, f)[name],
                               getattr(back.opt_state, f)[name])
    assert int(back.step) == 1 and back.step.dtype == torch.int32
    with pytest.raises(ValueError, match="optimizer"):
        ckpt.load_train_state(path, ts.init_train_state(
            cfg, opt_lib.sgd(0.1), device=CPU))


def test_multi_card_training_raises_naming_the_roadmap():
    cfg = get_smoke_config("yi-6b")
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 "
                                                  "item 10"):
        ts.make_train_step(cfg, opt_lib.sgd(0.1), grad_specs={})
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 "
                                                  "item 10"):
        train_cli.main(["--arch", "yi-6b", "--smoke", "--device", "cpu",
                        "--mesh", "2,2"])
