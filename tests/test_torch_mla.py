"""The port's Multi-head Latent Attention (``repro_torch.models.mla``) and
the deepseek-v2 slice against the JAX reference on the CPU.

Inputs come from numpy under a seed; weights are the reference's
``init_mla`` / ``init_moe`` trees (or its whole model's, through
``convert.lm_params``), carried across array for array.  Held to 1e-5
per module and to the LM bar of 1e-4 on logits with identical tokens:
``mla_queries``, ``mla_latents``, ``mla_prefill`` (whose attention runs
the flash kernel's plain version at Dk = nope + rope, Dv) and the
weight-absorbed ``mla_decode``, at the smoke widths and at deepseek-v2's
head dims (Dk 192, Dv 128) with a narrow model; ``flash_attention_plain``
with Dk != Dv against ``flash_attention_jnp``; the MoE with deepseek's
shared expert; the first dense layer (``first_k_dense``); the latent
cache; and the dropless serving invariant (a teacher-forced forward
against prefill + decode).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.configs.shapes import make_batch as jmake_batch
from repro.models import config as jconfig
from repro.models import layers as jL
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.models.attention import flash_attention_jnp
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L
from repro_torch.models import mla
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.attention import flash_attention_plain
from repro_torch.models.config import MLAConfig, MoEConfig
from repro_torch.serving.engine import generate

CPU = torch.device("cpu")
ARCH = "deepseek-v2-236b"
TOL = 1e-4

# (name, d_model, heads, q_lora, kv_lora, nope, rope, v): deepseek's smoke
# widths, and its published head dims (Dk 192, Dv 128) in a narrow model
WIDTHS = [("smoke", 128, 4, 64, 32, 32, 16, 32),
          ("head_dims_192_128", 96, 2, 48, 64, 128, 64, 128)]


def _mla_case(name, d, h, q_lora, kv_lora, nope, rope, v, b=2, s=37):
    jm = jconfig.MLAConfig(q_lora_rank=q_lora, kv_lora_rank=kv_lora,
                           qk_nope_head_dim=nope, qk_rope_head_dim=rope,
                           v_head_dim=v)
    m = MLAConfig(**dataclasses.asdict(jm))
    jparams = jax.tree.map(np.asarray, jmla.init_mla(
        jax.random.PRNGKey(len(name)), d, h, jm, jnp.float32))
    params = jax.tree.map(lambda a: torch.as_tensor(np.array(a)), jparams)
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    jcos, jsin = jL.rope_cos_sin(np.arange(s), rope, 10_000.0)
    cos, sin = L.rope_cos_sin(torch.arange(s), rope, 10_000.0)
    return jm, jparams, m, params, x, (jcos, jsin), (cos, sin)


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=1e-5)


@pytest.mark.parametrize("name,d,h,q_lora,kv_lora,nope,rope,v", WIDTHS,
                         ids=[w[0] for w in WIDTHS])
def test_mla_queries_latents_and_prefill_match(name, d, h, q_lora, kv_lora,
                                               nope, rope, v):
    jm, jparams, m, params, x, (jcos, jsin), (cos, sin) = _mla_case(
        name, d, h, q_lora, kv_lora, nope, rope, v)
    xt = torch.as_tensor(x)
    for got, want in zip(mla.mla_queries(params, xt, cos, sin, h, m, 1e-5),
                         jmla.mla_queries(jparams, x, jcos, jsin, h, jm,
                                          1e-5)):
        _close(got, want)
    for got, want in zip(mla.mla_latents(params, xt, cos, sin, m, 1e-5),
                         jmla.mla_latents(jparams, x, jcos, jsin, jm, 1e-5)):
        _close(got, want)
    out, ckv, kpe = mla.mla_prefill(params, xt, cos, sin, h, m, 1e-5)
    jout, jckv, jkpe = jmla.mla_prefill(jparams, x, jcos, jsin, h, jm, 1e-5)
    assert out.shape == (2, 37, d)
    _close(out, jout)
    _close(ckv, jckv)
    _close(kpe, jkpe)


@pytest.mark.parametrize("name,d,h,q_lora,kv_lora,nope,rope,v", WIDTHS,
                         ids=[w[0] for w in WIDTHS])
def test_mla_decode_matches(name, d, h, q_lora, kv_lora, nope, rope, v):
    """One token against latent caches of 37 slots, the last 9 not yet
    written (masked), different per sequence."""
    jm, jparams, m, params, _, _, _ = _mla_case(
        name, d, h, q_lora, kv_lora, nope, rope, v, s=1)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 1, d)).astype(np.float32)
    ckv = rng.standard_normal((2, 37, kv_lora)).astype(np.float32)
    kpe = rng.standard_normal((2, 37, rope)).astype(np.float32)
    valid = np.arange(37)[None] < np.array([[28], [20]])
    jcos, jsin = jL.rope_cos_sin(np.full((2, 1), 27), rope, 10_000.0)
    cos, sin = L.rope_cos_sin(torch.full((2, 1), 27), rope, 10_000.0)
    got = mla.mla_decode(params, torch.as_tensor(x), cos, sin,
                         torch.as_tensor(ckv), torch.as_tensor(kpe),
                         torch.as_tensor(valid), h, m, 1e-5)
    want = jmla.mla_decode(jparams, x, jcos, jsin, ckv, kpe, valid, h, jm,
                           1e-5)
    assert got.shape == (2, 1, d)
    _close(got, want)


@pytest.mark.parametrize("b,s,h,kv,d,dv,window", [
    (2, 70, 4, 4, 192, 128, 0), (1, 129, 2, 1, 192, 128, 0),
    (2, 50, 4, 2, 48, 32, 16), (1, 33, 2, 2, 136, 64, 0)])
def test_flash_plain_with_dk_ne_dv_matches_reference(b, s, h, kv, d, dv,
                                                     window):
    rng = np.random.default_rng(d + dv)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, dv)).astype(np.float32)
    scale = d ** -0.5 / 1.5
    want = flash_attention_jnp(q, k, v, causal=True, window=window,
                               scale=scale, q_block=s, k_block=s)
    for got in (flash_attention_plain(*map(torch.as_tensor, (q, k, v)),
                                      causal=True, window=window,
                                      scale=scale, q_block=32, k_block=32),
                flash_attention(*map(torch.as_tensor, (q, k, v)),
                                causal=True, window=window, scale=scale)):
        assert got.shape == (b, s, h, dv)
        _close(got, want)


def test_shared_expert_moe_matches_at_the_smoke_config():
    """deepseek's MoE (4 routed experts top-2, one shared expert) on the
    smoke widths: routing identical, y within 1e-5, aux within 1e-6."""
    jcfg = jget_smoke(ARCH).moe
    cfg = get_smoke_config(ARCH).moe
    assert cfg == MoEConfig(**dataclasses.asdict(jcfg))
    assert cfg.num_shared_experts == 1 and cfg.first_k_dense == 1
    jparams = jax.tree.map(np.asarray, jmoe.init_moe(
        jax.random.PRNGKey(11), 128, jcfg, jnp.float32))
    params = jax.tree.map(lambda a: torch.as_tensor(np.array(a)), jparams)
    assert "shared" in params
    x = np.random.default_rng(11).standard_normal((3, 24, 128)).astype(
        np.float32)
    for cf in (None, 0.5, 2.0):
        jy, jaux = jmoe._apply_moe_gspmd(jparams, x, jcfg,
                                         capacity_factor=cf)
        y, aux = moe.apply_moe(params, torch.as_tensor(x), cfg,
                               capacity_factor=cf)
        _close(y, jy)
        assert abs(float(aux) - float(jaux)) <= 1e-6
    # without the shared branch the outputs part: the branch is live
    y_routed, _ = moe.apply_moe({k: v for k, v in params.items()
                                 if k != "shared"}, torch.as_tensor(x), cfg)
    assert float((y - y_routed).abs().max()) > 1e-3


def _both(seed=0, cfg_fn=lambda c: c):
    jcfg, cfg = cfg_fn(jget_smoke(ARCH)), cfg_fn(get_smoke_config(ARCH))
    jparams = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    params = convert.lm_params(jax.tree.map(np.asarray, jparams), cfg, CPU)
    return jcfg, jparams, cfg, params


def _dropless(c):
    return dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=float(c.moe.num_experts)))


def test_first_dense_layer_and_converted_tree():
    """Layer 0 is ``mla_dense`` (a swiglu MLP of d_ff), the rest
    ``mla_moe``; ``lm_params`` carries the MLA tree and the float32
    router across unchanged, array for array."""
    jcfg, jparams, cfg, params = _both(seed=5)
    assert cfg.block_kinds() == ("mla_dense", "mla_moe")
    assert tf.segment_plan(cfg) == [("mla_dense", 1), ("mla_moe", 1)]
    dense, routed = params.blocks
    assert isinstance(dense, tf.MLADenseBlock) and "mlp" in dense
    assert isinstance(routed, tf.MLAMoEBlock) and "moe" in routed
    assert dense["mlp"]["w_gate"].shape == (cfg.d_model, cfg.d_ff)
    for block, seg in zip(params.blocks, jparams["segments"]):
        for name in ("q_a", "q_b", "kv_a", "kv_b", "o"):
            np.testing.assert_array_equal(block["mla"][name].numpy(),
                                          np.asarray(seg["mla"][name])[0])
    router = routed["moe"]["router"]
    assert router.dtype == torch.float32
    np.testing.assert_array_equal(
        router.numpy(), np.asarray(jparams["segments"][1]["moe"]["router"])[0])
    got = tf.init_params(cfg, seed=5, device=CPU)
    assert [type(b) for b in got.blocks] == [type(b) for b in params.blocks]


def test_latent_cache_layout_and_in_place_decode():
    """``init_cache`` and ``prefill`` hold (B, max_len, kv_lora) and (B,
    max_len, rope) latents, the prefill's padded with zeros, as the
    reference's; a decode step writes slot ``pos`` in place."""
    jcfg, jparams, cfg, params = _both(seed=6, cfg_fn=_dropless)
    m = cfg.mla
    zero = tf.init_cache(cfg, 2, 20, device=CPU)
    assert [tuple(c["ckv"].shape) for c in zero["layers"]] == \
        [(2, 20, m.kv_lora_rank)] * 2
    assert [tuple(c["kpe"].shape) for c in zero["layers"]] == \
        [(2, 20, m.qk_rope_head_dim)] * 2
    toks = jmake_batch(jcfg, jax.random.PRNGKey(6), 2, 13,
                       with_labels=False)["tokens"]
    t = torch.as_tensor(np.array(toks))
    _, jcache = jtf.prefill(jparams, jcfg, toks[:, :12], max_len=20)
    _, cache = tf.prefill(params, cfg, t[:, :12], max_len=20)
    for c, jc in zip(cache["layers"], jcache["segments"]):
        for name in ("ckv", "kpe"):
            assert c[name].shape[1] == 20
            _close(c[name], np.asarray(jc[name])[0])
            assert not c[name][:, 12:].any()
    buf = cache["layers"][1]["ckv"]
    _, cache = tf.decode_step(params, cfg, t[:, 12], cache)
    assert cache["layers"][1]["ckv"] is buf and buf[:, 12].abs().sum() > 0
    assert not buf[:, 13:].any()


@pytest.mark.parametrize("steps", [1, 6])
def test_dropless_serving_invariant(steps):
    """A dropless generation's logits (prefill, then decode steps) match
    the teacher-forced forward over prompt + generated tokens, and the
    reference's forward."""
    jcfg, jparams, cfg, params = _both(seed=8, cfg_fn=_dropless)
    batch = jmake_batch(jcfg, jax.random.PRNGKey(8), 3, 21,
                        with_labels=False)
    prompt = torch.as_tensor(np.array(batch["tokens"]))
    res = generate(params, cfg, {"tokens": prompt}, steps=steps)
    seq = torch.cat([prompt, res.tokens[:, :-1]], dim=1)
    full, _ = tf.forward(params, cfg, seq)
    got = full[:, prompt.shape[1] - 1:]
    assert float((got - res.logits).abs().max()) < TOL
    jfull, _ = jtf.forward(jparams, jcfg, jnp.asarray(seq.numpy()),
                           remat=False)
    assert float(np.abs(np.asarray(jfull) - full.numpy()).max()) < TOL
