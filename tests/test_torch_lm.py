"""The port's LM serving path against the JAX reference on the CPU.

At the yi, h2o-danube, rwkv6, zamba2, mistral-nemo, nemotron,
mixtral, deepseek-v2 (MLA + MoE with a shared expert and a first dense
layer), qwen2-vl (M-RoPE; its prompts with patch embeddings, which
the tests carry across with the prompt) and musicgen (four codebooks:
(B, K, S) tokens, (B, K, V) logits) smoke configs, with the
reference's weights carried across by
``convert.lm_params``: prefill and decode logits within 1e-4 of the
reference's (the bar of ``tests/test_models_consistency.py``, which holds
MoE configs to it dropless), the forward's aux loss within 1e-6, the ring
cache past the window (danube, and mixtral dropless), several decode
steps against the teacher-forced forward, greedy and categorical
generation token for token (mixtral at its published capacity factor,
whose prefill drops tokens), ``make_batch`` prompts, the configs, and
the serving CLI; and the raise sites of the multi-card slice that the
CPU reaches.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.configs.shapes import make_batch as jmake_batch
from repro.models import layers as jL
from repro.models import transformer as jtf
from repro.serving.engine import generate as jgenerate
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.shapes import make_batch
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.models import config as port_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import generate
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.train_step import make_train_step

CPU = torch.device("cpu")
PORTED = ("yi-6b", "h2o-danube-3-4b", "rwkv6-1.6b", "zamba2-1.2b",
          "mistral-nemo-12b", "nemotron-4-15b", "mixtral-8x7b",
          "deepseek-v2-236b", "qwen2-vl-7b", "musicgen-medium")
TOL = 1e-4


def _dropless(cfg):
    """``tests/test_models_consistency.py``'s: capacity_factor = E, so no
    MoE dispatch drops a token (the weights do not depend on it)."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


def _both(arch, seed=0):
    """(reference cfg, params) and (port cfg, LM) with the same weights."""
    jcfg, cfg = jget_smoke(arch), get_smoke_config(arch)
    jparams = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    params = convert.lm_params(jax.tree.map(np.asarray, jparams), cfg, CPU)
    return jcfg, jparams, cfg, params


def _tokens(jcfg, seed, b, s):
    """(B, S) text tokens, or (B, K, S) codes (a config with patch
    positions draws S text tokens after them); tests slice them on the
    last axis."""
    return jmake_batch(jcfg, jax.random.PRNGKey(seed), b,
                       s + jcfg.num_patch_positions,
                       with_labels=False)["tokens"]


def _torch_batch(batch):
    """A reference prompt batch (tokens, and patch embeds and positions
    where it has them) as tensors."""
    return {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}


def _err(a, b):
    return float(np.abs(np.asarray(a) - b.numpy()).max())


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_and_decode_logits_match(arch):
    jcfg, jparams, cfg, params = _both(arch)
    jcfg, cfg = _dropless(jcfg), _dropless(cfg)
    s = 33
    toks = _tokens(jcfg, 0, 2, s)
    t = torch.as_tensor(np.array(toks))
    jl, jcache = jtf.prefill(jparams, jcfg, toks[..., :s - 1],
                             max_len=s + 4)
    pl, cache = tf.prefill(params, cfg, t[..., :s - 1], max_len=s + 4)
    assert _err(jl, pl) < TOL
    jd, _ = jtf.decode_step(jparams, jcfg, toks[..., s - 1], jcache)
    pd, cache = tf.decode_step(params, cfg, t[..., s - 1], cache)
    assert _err(jd, pd) < TOL
    assert cache["pos"] == s
    full, aux = tf.forward(params, cfg, t)
    jfull, jaux = jtf.forward(jparams, jcfg, toks, remat=False)
    assert _err(jfull, full) < TOL
    assert aux.shape == () and abs(float(aux) - float(jaux)) <= 1e-6
    assert (float(aux) > 0) == (cfg.moe is not None)
    assert float((full[..., s - 1, :] - pd).abs().max()) < TOL


@pytest.mark.parametrize("arch", ["yi-6b", "rwkv6-1.6b"])
def test_decode_from_a_zero_cache_matches(arch):
    """``init_cache`` then one decode step is the one-token forward, as
    the reference's."""
    jcfg, jparams, cfg, params = _both(arch, seed=4)
    toks = _tokens(jcfg, 4, 2, 1)
    cache = tf.init_cache(cfg, 2, 8, device=CPU)
    lg, cache = tf.decode_step(params, cfg, torch.as_tensor(
        np.array(toks[:, 0])), cache)
    jlg, _ = jtf.decode_step(jparams, jcfg, toks[:, 0],
                             jtf.init_cache(jcfg, 2, 8))
    assert _err(jlg, lg) < TOL and cache["pos"] == 1


@pytest.mark.parametrize("kind", ["swiglu", "squared_relu", "gelu"])
def test_layers_match(kind):
    rng = np.random.default_rng(5)
    d, f = 48, 96
    x = rng.standard_normal((2, 7, 4, d)).astype(np.float32)
    jmlp = jax.tree.map(np.asarray, jL.init_mlp(jax.random.PRNGKey(5), d, f,
                                                kind, np.float32))
    mlp = {k: torch.as_tensor(v.copy()) for k, v in jmlp.items()}
    np.testing.assert_allclose(
        L.apply_mlp(mlp, torch.as_tensor(x), kind).numpy(),
        np.asarray(jL.apply_mlp(jmlp, x, kind)), atol=1e-5, rtol=1e-5)
    scale = rng.standard_normal(d).astype(np.float32)
    np.testing.assert_allclose(
        L.rmsnorm({"scale": torch.as_tensor(scale)}, torch.as_tensor(x),
                  1e-5).numpy(),
        np.asarray(jL.rmsnorm({"scale": scale}, x, 1e-5)), atol=1e-5,
        rtol=1e-5)
    pos = np.arange(7)
    for p in (pos, np.stack([pos, pos + 3])):
        cos, sin = L.rope_cos_sin(torch.as_tensor(p), d, 5e6)
        jcos, jsin = jL.rope_cos_sin(p, d, 5e6)
        np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=2e-6)
        np.testing.assert_allclose(
            L.apply_rope(torch.as_tensor(x), cos, sin).numpy(),
            np.asarray(jL.apply_rope(x, jcos, jsin)), atol=2e-5, rtol=1e-5)


def test_ring_cache_past_the_window():
    """Decode once the danube ring buffer has wrapped (pos > window)."""
    _ring_past_the_window("h2o-danube-3-4b")


def test_moe_ring_cache_past_the_window_dropless():
    """The same for mixtral, dropless as
    ``tests/test_models_consistency.py`` runs it."""
    _ring_past_the_window("mixtral-8x7b")


def _ring_past_the_window(arch):
    jcfg, jparams, cfg, params = _both(arch, seed=1)
    jcfg, cfg = _dropless(jcfg), _dropless(cfg)
    s = cfg.sliding_window + 17
    toks = _tokens(jcfg, 1, 2, s)
    t = torch.as_tensor(np.array(toks))
    _, cache = tf.prefill(params, cfg, t[:, :s - 1], max_len=s + 4)
    assert cache["layers"][0]["k"].shape[1] == cfg.sliding_window
    lg, _ = tf.decode_step(params, cfg, t[:, s - 1], cache)
    jfull, _ = jtf.forward(jparams, jcfg, toks, remat=False)
    assert _err(jfull[:, s - 1], lg) < TOL


@pytest.mark.parametrize("arch", ["yi-6b", "rwkv6-1.6b", "musicgen-medium"])
def test_multi_step_decode_tracks_forward(arch):
    jcfg, jparams, cfg, params = _both(arch, seed=2)
    s, n_dec = 24, 5
    toks = _tokens(jcfg, 2, 2, s)
    t = torch.as_tensor(np.array(toks))
    jfull, _ = jtf.forward(jparams, jcfg, toks, remat=False)
    _, cache = tf.prefill(params, cfg, t[..., :s - n_dec], max_len=s + 2)
    for i in range(n_dec):
        pos = s - n_dec + i
        lg, cache = tf.decode_step(params, cfg, t[..., pos], cache)
        assert _err(jfull[..., pos, :], lg) < TOL, i


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("sample", ["greedy", "categorical"])
def test_generate_matches_reference_tokens(arch, sample):
    jcfg, jparams, cfg, params = _both(arch, seed=3)
    batch = jmake_batch(jcfg, jax.random.PRNGKey(3), 2, 40,
                        with_labels=False)
    key = jax.random.PRNGKey(1)
    want = jgenerate(jparams, jcfg, batch, steps=8, sample=sample,
                     temperature=0.8, key=key)
    got = generate(params, cfg, _torch_batch(batch),
                   steps=8, sample=sample, temperature=0.8,
                   key=convert.key_from_data(np.asarray(key), CPU))
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    assert got.tokens.dtype == torch.int32
    k = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    assert got.logits.shape == (2, 8, *k, cfg.vocab_size)


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("b,s,seed", [(2, 33, 0), (4, 2048, 7)])
def test_make_batch_prompts_match(arch, b, s, seed):
    jcfg = jget_config(arch)
    s += jcfg.num_patch_positions
    want = jmake_batch(jcfg, jax.random.PRNGKey(seed), b, s)
    got = make_batch(get_config(arch), torch.as_tensor(
        np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)), b, s)
    assert got.keys() == want.keys()
    for name in ("tokens", "labels", "positions"):
        if name in want:
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))


@pytest.mark.parametrize("arch", PORTED)
def test_configs_match_the_reference(arch):
    for jc, c in ((jget_config(arch), get_config(arch)),
                  (jget_smoke(arch), get_smoke_config(arch))):
        assert c.num_params() == jc.num_params()
        assert c.block_kinds() == jc.block_kinds()
        assert tf.segment_plan(c) == jtf.segment_plan(jc)
        for f in dataclasses.fields(c):
            mine, theirs = getattr(c, f.name), getattr(jc, f.name)
            if dataclasses.is_dataclass(mine):
                mine, theirs = (dataclasses.asdict(x) for x in (mine, theirs))
            assert mine == theirs, f.name
    full = get_config(arch)
    params = tf.init_params(get_smoke_config(arch), device=CPU)
    assert sum(p.numel() for p in params.parameters()) == \
        get_smoke_config(arch).num_params()
    assert full.num_params() == jget_config(arch).num_params()


def test_other_archs_raise_naming_the_roadmap():
    """Every arch is ported; what the CPU can reach of the multi-card
    slice raises naming the roadmap: sharded gradients in the train step
    and the train CLI's ``--mesh``."""
    assert set(PORTED) == set(ARCH_IDS)
    with pytest.raises(KeyError):
        get_config("gpt-2")
    cfg = get_smoke_config("yi-6b")
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item "
                                                  "10.5"):
        make_train_step(cfg, opt_lib.adamw(), grad_specs={"embed": None})
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item "
                                                  "10.5"):
        train_cli.main(["--arch", "yi-6b", "--smoke", "--device", "cpu",
                        "--mesh", "2,1"])


def _port_cfg(jc):
    """The reference's config as the port's, field by field (the port
    has no use_pallas and no sharding specs)."""
    kw = {}
    for f in dataclasses.fields(ModelConfig):
        v = getattr(jc, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(port_config, type(v).__name__)(
                **dataclasses.asdict(v))
        kw[f.name] = v
    return ModelConfig(**kw)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_num_params_and_kinds_match_for_every_family(arch):
    for jc in (jget_config(arch), jget_smoke(arch)):
        c = _port_cfg(jc)
        assert c.num_params() == jc.num_params()
        assert c.block_kinds() == jc.block_kinds()
        assert c.resolved_head_dim == jc.resolved_head_dim


def test_serve_cli_runs_on_the_cpu(capsys):
    serve.main(["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "12", "--gen", "3"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("serving rwkv6-smoke")
    assert "on CPU" in out[0]
    report = json.loads(out[-1])
    assert report["device_name"] == "CPU" and report["gen"] == 3
    assert np.asarray(report["tokens"]).shape == (2, 3)


def test_serve_cli_serves_codebooks_on_the_cpu(capsys):
    """``--arch musicgen-medium``: (B, K, gen) codes through the CLI,
    sampled, from the reference CLI's prompt (``PRNGKey(0)``: (B, K, S)
    codes, bit-equal); greedy and sampled generation against the
    reference's is ``test_generate_matches_reference_tokens``."""
    serve.main(["--arch", "musicgen-medium", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "12", "--gen", "3",
                "--sample", "categorical"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("serving musicgen-smoke")
    assert np.asarray(json.loads(out[-1])["tokens"]).shape == (2, 4, 3)
    run = serve.serve("musicgen-medium", smoke=True, batch=2, prompt_len=12,
                      gen=3, device="cpu", verbose=False)
    prompt = jmake_batch(jget_smoke("musicgen-medium"),
                         jax.random.PRNGKey(0), 2, 12, with_labels=False)
    np.testing.assert_array_equal(run.prompt["tokens"].numpy(),
                                  np.asarray(prompt["tokens"]))
    assert run.result.tokens.shape == (2, 4, 3)


def test_serve_matches_reference_cli_draws():
    """The launcher's prompt and categorical key are the reference CLI's
    (``PRNGKey(0)`` prompt, ``PRNGKey(1)`` sampling) at seed 0."""
    run = serve.serve("yi-6b", smoke=True, batch=2, prompt_len=9, gen=2,
                      sample="categorical", device="cpu", verbose=False)
    want = jmake_batch(jget_smoke("yi-6b"), jax.random.PRNGKey(0), 2, 9,
                       with_labels=False)["tokens"]
    np.testing.assert_array_equal(run.prompt["tokens"].numpy(),
                                  np.asarray(want))


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve("yi-6b", smoke=True, verbose=False)
