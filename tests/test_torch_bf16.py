"""The port's bfloat16 LM path against the JAX reference on the CPU.

* ``convert.lm_params`` carries the reference's bfloat16 param tree bit
  for bit, every leaf in its own dtype (the MoE router float32);
* the ten smoke configs in bfloat16 (parameters and compute, the
  reference dry-run's overrides; MoE dropless), from the reference's
  bfloat16 weights: the prefill's and one decode step's logits within
  ``K[arch]`` times the reference's own bfloat16-vs-float32 gap (the
  reference in float32 on the same weights widened, same tokens, per
  path) of the reference's bfloat16 logits;
* checkpoints in bfloat16 (the reference's bytes, each package restores
  the other's file, a bfloat16 ``TrainState`` round-trips) and
  ``restore_like`` against the reference's;
* the plain bfloat16 flash at D 192 / Dv 128 against
  ``flash_attention_jnp`` in bfloat16.

``K`` comes from ``measure/bf16_gap_cpu.py``: 8 seeds (weights and
tokens), each under ``torch.set_num_threads(1)`` and the default thread
count (8 here; the two gave the same largest ratios).  The largest
ratio of the port's distance to the reference's gap over those 16 runs
and both paths, per arch: yi-6b 1.174, h2o-danube-3-4b 1.198, rwkv6-1.6b
1.085, zamba2-1.2b 1.695, mistral-nemo-12b 1.211, nemotron-4-15b 1.183,
mixtral-8x7b 1.339, deepseek-v2-236b 1.451, qwen2-vl-7b 1.239,
musicgen-medium 1.265 (means 0.74-1.03).  ``K`` is twice each, rounded
up to the next half.  zamba2's tail (1.695 at seed 0; mean 1.03) is no
misplaced cast: the reference runs its SSD scan's einsums and exps in
bfloat16, the port (its plain version and the card's kernel) in
float32, and the port's logits lie on average 0.70x as far from the
reference's float32 run as the reference's own bfloat16 logits do;
rounding A to bfloat16 as the reference does, or running the port's scan
in bfloat16, took seed 0 from 1.65 to 1.69 and 2.04.  A bar of 1e-4
(the float32 one) cannot hold here: bfloat16 keeps 8 bits, and the
reference's own gap is ~3e-2 at logits of ~3.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_smoke_config as jget_smoke
from repro.configs.shapes import make_batch as jmake_batch
from repro.models import transformer as jtf
from repro.models.attention import flash_attention_jnp
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import transformer as tf
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.train_step import param_tree

CPU = torch.device("cpu")
ARCHS = ("yi-6b", "h2o-danube-3-4b", "rwkv6-1.6b", "zamba2-1.2b",
         "mistral-nemo-12b", "nemotron-4-15b", "mixtral-8x7b",
         "deepseek-v2-236b", "qwen2-vl-7b", "musicgen-medium")
# the bar's multiple of the reference's gap, per arch (module docstring)
K = {"yi-6b": 2.5, "h2o-danube-3-4b": 2.5, "rwkv6-1.6b": 2.5,
     "zamba2-1.2b": 3.5, "mistral-nemo-12b": 2.5, "nemotron-4-15b": 2.5,
     "mixtral-8x7b": 3.0, "deepseek-v2-236b": 3.0, "qwen2-vl-7b": 2.5,
     "musicgen-medium": 3.0}
B, S = 2, 33
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
# the reference jitted, as its serving engine runs it (and 3-4x faster
# here than op by op)
_jinit = jax.jit(jtf.init_params, static_argnums=1)
_jprefill = jax.jit(jtf.prefill, static_argnums=1, static_argnames="max_len")
_jdecode = jax.jit(jtf.decode_step, static_argnums=1)


def _dropless(cfg):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


@functools.lru_cache(maxsize=None)
def case_models(arch: str, seed: int = 0):
    """(reference bf16 cfg, its bf16 params, port bf16 cfg, the port's LM
    carried across bit for bit); built once an (arch, seed)."""
    jcfg = _dropless(dataclasses.replace(jget_smoke(arch), **BF16))
    cfg = _dropless(get_smoke_config(arch, **BF16))
    jparams = _jinit(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jparams, cfg, convert.lm_params(
        jax.tree.map(np.asarray, jparams), cfg, CPU)


def _tokens(jcfg, seed: int):
    """(B, S) text tokens, or (B, K, S) codes; a config with patch
    positions draws S text tokens after them, as ``tests/test_torch_lm.py``."""
    return jmake_batch(jcfg, jax.random.PRNGKey(seed), B,
                       S + jcfg.num_patch_positions,
                       with_labels=False)["tokens"][..., :S]


def reference_logits(jcfg, jparams, toks) -> dict:
    """The reference's prefill (first S - 1 tokens) and one decode step
    (the last token), as float32 numpy."""
    pl, cache = _jprefill(jparams, jcfg, toks[..., :S - 1], max_len=S + 4)
    dl, _ = _jdecode(jparams, jcfg, toks[..., S - 1], cache)
    return {"prefill": np.asarray(pl, np.float32),
            "decode": np.asarray(dl, np.float32)}


def port_logits(cfg, params, toks) -> dict:
    t = torch.as_tensor(np.array(toks))
    with torch.no_grad():
        pl, cache = tf.prefill(params, cfg, t[..., :S - 1], max_len=S + 4)
        dl, _ = tf.decode_step(params, cfg, t[..., S - 1], cache)
    return {"prefill": pl.float().numpy(), "decode": dl.float().numpy()}


def _gap(a: dict, b: dict) -> dict:
    return {k: float(np.abs(a[k] - b[k]).max()) for k in a}


@functools.lru_cache(maxsize=None)
def _reference(arch: str, seed: int):
    """The reference's bf16 logits, and its float32 logits on the same
    weights widened, per path."""
    jcfg, jparams, _, _ = case_models(arch, seed)
    toks = _tokens(jcfg, seed)
    j32 = dataclasses.replace(jcfg, param_dtype="float32",
                              compute_dtype="float32")
    wide = jax.tree.map(lambda a: a.astype(jnp.float32)
                        if a.dtype == jnp.bfloat16 else a, jparams)
    return (reference_logits(jcfg, jparams, toks),
            reference_logits(j32, wide, toks))


def logit_gaps(arch: str, seed: int = 0) -> dict:
    """At (arch, seed): the reference's bf16-vs-f32 gap (``gap``), the
    port's distance to the reference's bf16 logits (``port``), their
    ``ratio`` per path, the port's distance to the reference's float32
    logits (``port_vs_f32``), and the largest logit."""
    jcfg, _, cfg, params = case_models(arch, seed)
    ref, ref32 = _reference(arch, seed)
    gap = _gap(ref, ref32)
    got = port_logits(cfg, params, _tokens(jcfg, seed))
    port = _gap(got, ref)
    return dict(gap=gap, port=port,
                ratio={k: port[k] / gap[k] for k in gap},
                port_vs_f32=_gap(got, ref32),
                max_abs_logit=float(np.abs(ref["prefill"]).max()))


def _words(x) -> np.ndarray:
    """A bf16 array's or tensor's 16-bit words; other dtypes as they are."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.contiguous().view(torch.int16).numpy()
                if x.dtype == torch.bfloat16 else x.numpy())
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _same_leaf(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_words(got), _words(want))


def _same_tree(ptree, jtree, layer=None) -> int:
    """Every leaf of the reference tree (its ``layer``-th slice when the
    tree is a stacked segment) against the port's, bit for bit; the count
    of leaves."""
    n = 0
    for k, jv in jtree.items():
        if isinstance(jv, dict):
            n += _same_tree(ptree[k], jv, layer)
        else:
            _same_leaf(ptree[k], np.asarray(jv)[layer] if layer is not None
                       else jv)
            n += 1
    return n


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_carry_bf16_bit_for_bit(arch):
    """``convert.lm_params`` on the reference's bfloat16 tree: every leaf
    in its own dtype (the MoE router float32), its words equal, and every
    leaf of the reference's tree reached."""
    jcfg, jparams, cfg, params = case_models(arch)
    assert cfg.param_dtype == "bfloat16"
    n = _same_tree(params.embed, jparams["embed"])
    n += _same_tree(params.final_norm, jparams["final_norm"])
    if not cfg.tie_embeddings:
        _same_leaf(params.lm_head, jparams["lm_head"])
        n += 1
    if cfg.shared_attn_every:
        n += _same_tree(params.shared_block, jparams["shared_block"])
    blocks = iter(params.blocks)
    for (_, count), seg in zip(tf.segment_plan(cfg), jparams["segments"]):
        for i in range(count):
            n += _same_tree(next(blocks), seg, layer=i)
    assert next(blocks, None) is None
    # every leaf once: the stacked segments' once per layer
    rest = {k: v for k, v in jparams.items() if k != "segments"}
    assert n == len(jax.tree.leaves(rest)) + sum(
        count * len(jax.tree.leaves(seg)) for (_, count), seg in
        zip(tf.segment_plan(cfg), jparams["segments"]))
    assert jax.tree.leaves(jparams["embed"])[0].dtype == jnp.bfloat16


def test_lm_train_state_carries_bf16():
    """``convert.lm_train_state`` on a reference adam ``TrainState`` over
    the bf16 mixtral smoke parameters (one update taken, so the moments
    are not zero): parameters bit for bit in their dtypes (bf16, the
    router float32), both moments float32 as ``lm_param_tree`` carries
    them, the steps equal."""
    jcfg, jparams, cfg, params = case_models("mixtral-8x7b")
    opt = jopt.adam(1e-3)
    grads = jax.tree.map(lambda a: jnp.full_like(a, 0.5), jparams)
    _, moments = opt.update(grads, opt.init(jparams), jparams)
    jstate = jax.tree.map(np.asarray, jts.TrainState(
        jparams, moments, jnp.asarray(3, jnp.int32)))
    state = convert.lm_train_state(jstate, cfg, CPU)
    got = param_tree(state.params)
    want = param_tree(params)
    assert got.keys() == want.keys()
    assert {p.dtype for p in got.values()} == {torch.bfloat16,
                                               torch.float32}  # router
    for name, p in got.items():
        assert p.dtype == want[name].dtype and p.requires_grad
        assert np.array_equal(_words(p), _words(want[name]))
    for field in ("mu", "nu"):
        tree = getattr(state.opt_state, field)
        ref = convert.lm_param_tree(getattr(jstate.opt_state, field), cfg,
                                    CPU)
        assert tree.keys() == got.keys()
        for name, m in tree.items():
            assert m.dtype == torch.float32 and torch.equal(m, ref[name])
        assert any(bool(m.abs().max() > 0) for m in tree.values())
    assert int(state.step) == 3 and int(state.opt_state.step) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_within_k_reference_gaps(arch):
    """The port's bf16 prefill and decode-step logits lie within
    ``K[arch]`` times the reference's own bf16-vs-f32 gap (per path) of
    the reference's bf16 logits, at the same bf16 weights and tokens."""
    g = logit_gaps(arch)
    for path, err in g["port"].items():
        assert 0 < g["gap"][path] < 0.5 * g["max_abs_logit"], (path, g)
        assert err <= K[arch] * g["gap"][path], (path, err, g)


def _reference_dtype_tree():
    """``tests/test_substrate.py::test_checkpoint_preserves_dtypes``'s."""
    return {"a": jnp.ones((2,), jnp.bfloat16),
            "b": jnp.ones((3,), jnp.int32),
            "c": (jnp.zeros((1,)), "meta", 7)}


def test_checkpoint_bytes_and_files_cross_in_bf16(tmp_path):
    """The port writes the reference's bytes for the reference's dtype
    tree (bf16 as its raw words under ``"bfloat16"``), and each package
    restores the other's file: dtypes, values and the tuple's scalars."""
    jtree = _reference_dtype_tree()
    ptree = {"a": torch.ones(2, dtype=torch.bfloat16),
             "b": torch.ones(3, dtype=torch.int32),
             "c": (torch.zeros(1), "meta", 7)}
    jpath, ppath = str(tmp_path / "ref.msgpack"), str(tmp_path / "port.msgpack")
    jckpt.save(jpath, jtree)
    ckpt.save(ppath, ptree)
    with open(jpath, "rb") as f, open(ppath, "rb") as g:
        assert f.read() == g.read()
    assert ckpt.packb(ckpt._encode(ptree)) == open(jpath, "rb").read()
    got = ckpt.restore(jpath)
    assert got["a"].dtype == torch.bfloat16 and got["b"].dtype == torch.int32
    assert got["c"][1] == "meta" and got["c"][2] == 7
    for k in ("a", "b"):
        _same_leaf(got[k], jtree[k])
    _same_leaf(got["c"][0], jtree["c"][0])
    back = jckpt.restore(ppath)
    assert back["a"].dtype == jnp.bfloat16 and back["b"].dtype == jnp.int32
    assert back["c"][1] == "meta" and back["c"][2] == 7
    np.testing.assert_array_equal(_words(back["a"]), _words(jtree["a"]))
    # a reference bf16 array (ml_dtypes) handed to the port's save
    ckpt.save(ppath, jax.tree.map(np.asarray, {"a": jtree["a"]}))
    jckpt.save(jpath, {"a": jtree["a"]})
    with open(jpath, "rb") as f, open(ppath, "rb") as g:
        assert f.read() == g.read()


def test_bf16_train_state_round_trips(tmp_path):
    """A bf16 LM ``TrainState`` after one adamw step (yi-6b smoke) through
    ``save_train_state`` / ``load_train_state``: parameters, both moments
    and the step bit for bit, each in its dtype."""
    from repro_torch.data.pipeline import batch_for_config
    from repro_torch.training import train_step as ts
    cfg = get_smoke_config("yi-6b", **BF16)
    opt = opt_lib.adamw(1e-3)
    state = ts.init_train_state(cfg, opt, seed=1, device=CPU)
    state, _ = ts.make_train_step(cfg, opt)(
        state, batch_for_config(cfg, 0, 2, 16))
    path = str(tmp_path / "bf16.state.msgpack")
    ckpt.save_train_state(path, state)
    back = ckpt.load_train_state(path, ts.init_train_state(
        cfg, opt, seed=2, device=CPU))
    saved = param_tree(state.params)
    assert next(iter(saved.values())).dtype == torch.bfloat16
    for name, p in param_tree(back.params).items():
        assert p.dtype == saved[name].dtype and torch.equal(p, saved[name])
        for f in ("mu", "nu"):
            got, want = (getattr(s.opt_state, f)[name] for s in (back, state))
            assert got.dtype == want.dtype and torch.equal(got, want)
    assert int(back.step) == int(state.step) == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_restore_like_matches_reference(tmp_path, dtype):
    """``tests/test_substrate.py::test_checkpoint_roundtrip``'s kind of
    tree, a mixtral smoke adam ``TrainState`` (the reference's parameters
    in ``dtype``, its NamedTuples), saved by the reference: the port's
    ``restore_like`` over the tree carried across gives the template's
    structure and the reference's ``restore_like`` leaves bit for bit; a
    file the port wrote of the template gives the same; a template with
    another leaf count raises."""
    jparams = case_models("mixtral-8x7b")[1]
    if dtype == "float32":
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    jstate = jts.TrainState(jparams, jopt.adam(1e-3).init(jparams),
                            jnp.zeros((), jnp.int32))
    path = str(tmp_path / "ckpt.msgpack")
    jckpt.save(path, jstate)
    want = jax.tree.leaves(jckpt.restore_like(path, jstate))
    template = jax.tree.map(lambda a: convert.host_tensor(np.asarray(a)),
                            jstate)
    for file in (path, str(tmp_path / "port.msgpack")):
        if file != path:
            ckpt.save(file, template)
        got = ckpt.restore_like(file, template)
        assert type(got) is type(jstate)
        assert type(got.opt_state) is type(jstate.opt_state)
        assert set(got.params) == set(jstate.params)
        leaves = jax.tree.leaves(got)
        assert len(leaves) == len(want)
        for g, w in zip(leaves, want):
            _same_leaf(g, w)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore_like(path, template._replace(step=None))


def test_plain_bf16_flash_at_mla_head_dims_matches_reference():
    """``flash_attention`` on CPU tensors (its plain version) in bf16 at
    Dk 192 / Dv 128, V a strided view as MLA hands it over, against
    ``flash_attention_jnp`` in bf16: within one bf16 step (2^-8 relative)
    of the reference's output plus 2^-8 absolute."""
    b, s, h = 2, 64, 4
    rng = np.random.default_rng(192)
    q = rng.standard_normal((b, s, h, 192)).astype(jnp.bfloat16)
    kv = rng.standard_normal((b, s, h, 256)).astype(jnp.bfloat16)
    k = kv[..., :192]
    v = kv[..., 128:]
    want = np.asarray(flash_attention_jnp(q, k, v, causal=True, q_block=32,
                                          k_block=32), np.float32)
    qt, kvt = convert.host_tensor(q), convert.host_tensor(kv)
    got = flash_attention(qt, kvt[..., :192], kvt[..., 128:], causal=True)
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, h, 128)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2 ** -8,
                               rtol=2 ** -8)
