"""The port's M-RoPE and patch-embedding slice (qwen2-vl) against the JAX
reference on the CPU.

``mrope_cos_sin`` against the reference's tables; ``make_batch``'s
vision branch (tokens and positions bit-equal through the port's
threefry; the patch embeddings from its ``normal``, whose last-bit gaps
are why the model tests carry the reference's prompt across); prefill,
decode and generation with patches and (3, B, S) positions at the LM bar
(logits within 1e-4, tokens identical), including the reference's cache
sizing in ``generate`` (text length + steps + 1 slots, patches not
counted, so the ring holds fewer slots than the prompt) and its decode
position (``cache["pos"]`` on all three rows); the serving invariant
with a cache that covers patches, text and generated tokens and the
same positions given to the forward and to every decode step; and the
serving CLI's prompt length.
"""
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
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.shapes import make_batch, mrope_positions
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as tf
from repro_torch.serving.engine import generate

CPU = torch.device("cpu")
ARCH = "qwen2-vl-7b"
TOL = 1e-4


def _key(seed):
    return torch.as_tensor(np.asarray(jax.random.PRNGKey(seed))
                           .astype(np.int64))


def _err(a, b):
    return float(np.abs(np.asarray(a) - b.numpy()).max())


@pytest.mark.parametrize("head_dim,sections,theta", [
    (64, (8, 12, 12), 10_000.0), (128, (16, 24, 24), 1_000_000.0),
    (32, (4, 4, 8), 500.0)])
def test_mrope_cos_sin_matches(head_dim, sections, theta):
    rng = np.random.default_rng(head_dim)
    pos = rng.integers(0, 4000, (3, 2, 19)).astype(np.int32)
    cos, sin = L.mrope_cos_sin(torch.as_tensor(pos), head_dim, theta,
                               sections)
    jcos, jsin = jL.mrope_cos_sin(pos, head_dim, theta, sections)
    assert cos.shape == (2, 19, head_dim // 2)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=2e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=2e-6)
    # equal rows give standard RoPE
    same = np.broadcast_to(pos[:1], pos.shape).copy()
    c1, s1 = L.mrope_cos_sin(torch.as_tensor(same), head_dim, theta,
                             sections)
    c0, s0 = L.rope_cos_sin(torch.as_tensor(pos[0]), head_dim, theta)
    assert torch.equal(c1, c0) and torch.equal(s1, s0)
    with pytest.raises(ValueError, match="sum"):
        L.mrope_cos_sin(torch.as_tensor(pos), head_dim + 2, theta, sections)


@pytest.mark.parametrize("smoke,b,s,seed", [(True, 2, 40, 0),
                                            (True, 3, 17, 5),
                                            (False, 2, 1024 + 33, 1)])
def test_make_batch_vision_branch_matches(smoke, b, s, seed):
    jcfg = jget_smoke(ARCH) if smoke else jget_config(ARCH)
    cfg = get_smoke_config(ARCH) if smoke else get_config(ARCH)
    want = jmake_batch(jcfg, jax.random.PRNGKey(seed), b, s)
    got = make_batch(cfg, _key(seed), b, s)
    assert got.keys() == want.keys()
    p = cfg.num_patch_positions
    assert got["tokens"].shape == (b, s - p)
    for name in ("tokens", "labels", "positions"):
        assert got[name].dtype == torch.int32
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
    pe, jpe = got["patch_embeds"].numpy(), np.asarray(want["patch_embeds"])
    assert pe.shape == (b, p, cfg.d_model) and pe.dtype == np.float32
    # normal's last-bit gaps, times 0.02
    np.testing.assert_allclose(pe, jpe, rtol=0, atol=1e-7)
    assert (pe == jpe).mean() > 0.95
    with pytest.raises(ValueError, match="patch positions"):
        make_batch(cfg, _key(seed), b, p)


def test_mrope_positions_grid():
    pos = mrope_positions(16, 20, 2, CPU)
    assert pos.shape == (3, 2, 20)
    np.testing.assert_array_equal(pos[0, 0, :16], 0)
    np.testing.assert_array_equal(pos[1, 0, :16], np.repeat(np.arange(4), 4))
    np.testing.assert_array_equal(pos[2, 0, :16], np.tile(np.arange(4), 4))
    np.testing.assert_array_equal(pos[:, 1, 16:], [[4, 5, 6, 7]] * 3)


def _both(seed=0):
    jcfg, cfg = jget_smoke(ARCH), get_smoke_config(ARCH)
    jparams = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    params = convert.lm_params(jax.tree.map(np.asarray, jparams), cfg, CPU)
    return jcfg, jparams, cfg, params


def _torch_batch(batch):
    return {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}


def test_prefill_and_decode_with_patches_match():
    """Prefill over 16 patch and 18 text positions (M-RoPE grid), then
    decode steps at the reference's default position and at explicit
    (3, B, 1) positions; the forward with patches."""
    jcfg, jparams, cfg, params = _both(seed=2)
    jb = jmake_batch(jcfg, jax.random.PRNGKey(2), 2, 34, with_labels=False)
    b = _torch_batch(jb)
    jl, jcache = jtf.prefill(jparams, jcfg, jb["tokens"][:, :-1],
                             positions=jb["positions"][:, :, :-1],
                             patch_embeds=jb["patch_embeds"], max_len=40)
    pl, cache = tf.prefill(params, cfg, b["tokens"][:, :-1],
                           positions=b["positions"][:, :, :-1],
                           patch_embeds=b["patch_embeds"], max_len=40)
    assert _err(jl, pl) < TOL and cache["pos"] == 33
    tok = jb["tokens"][:, -1]
    jd, jcache2 = jtf.decode_step(jparams, jcfg, tok, jcache)
    pd, cache = tf.decode_step(params, cfg, b["tokens"][:, -1], cache)
    assert _err(jd, pd) < TOL
    jpos = jb["positions"][:, :, -1:]
    jd, _ = jtf.decode_step(jparams, jcfg, tok, jcache2, positions=jpos)
    pd, cache = tf.decode_step(params, cfg, b["tokens"][:, -1], cache,
                               positions=b["positions"][:, :, -1:])
    assert _err(jd, pd) < TOL and cache["pos"] == 35
    jfull, _ = jtf.forward(jparams, jcfg, jb["tokens"], jb["positions"],
                           jb["patch_embeds"], remat=False)
    full, aux = tf.forward(params, cfg, b["tokens"], b["positions"],
                           b["patch_embeds"])
    assert full.shape == (2, 34, cfg.vocab_size) and float(aux) == 0.0
    assert _err(jfull, full) < TOL
    with pytest.raises(ValueError, match="3, B, S"):
        tf.forward(params, cfg, b["tokens"], b["positions"][0])


@pytest.mark.parametrize("sample", ["greedy", "categorical"])
def test_generate_with_patches_sizes_the_cache_as_the_reference(sample):
    """40 positions (16 patches, 24 text) and 8 steps: the reference
    sizes the cache from the text alone (24 + 8 + 1 = 33 slots), so the
    ring wraps in the prefill; the port reproduces it token for token."""
    jcfg, jparams, cfg, params = _both(seed=3)
    jb = jmake_batch(jcfg, jax.random.PRNGKey(3), 2, 40, with_labels=False)
    key = jax.random.PRNGKey(1)
    want = jgenerate(jparams, jcfg, jb, steps=8, sample=sample,
                     temperature=0.8, key=key)
    got = generate(params, cfg, _torch_batch(jb), steps=8, sample=sample,
                   temperature=0.8,
                   key=convert.key_from_data(np.asarray(key), CPU))
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    ring = got.cache["layers"][0]["k"]
    assert ring.shape[1] == 24 + 8 + 1 < 40
    assert got.cache["pos"] == 40 + 7
    np.testing.assert_allclose(
        ring.numpy(), np.asarray(want.cache["segments"][0]["k"])[0],
        atol=1e-5)


def test_serving_invariant_with_its_own_prefill():
    """A cache covering patches, text and generated tokens, the same
    M-RoPE positions given to the forward and to every decode step:
    prefill + decode logits match the teacher-forced forward's."""
    jcfg, jparams, cfg, params = _both(seed=4)
    p, text, steps = cfg.num_patch_positions, 12, 6
    jb = jmake_batch(jcfg, jax.random.PRNGKey(4), 2, p + text + steps - 1,
                     with_labels=False)
    b = _torch_batch(jb)
    pos, toks = b["positions"], b["tokens"]
    logits, cache = tf.prefill(params, cfg, toks[:, :text],
                               positions=pos[:, :, :p + text],
                               patch_embeds=b["patch_embeds"],
                               max_len=p + text + steps)
    outs = [logits]
    for i in range(steps - 1):
        at = p + text + i
        lg, cache = tf.decode_step(params, cfg, toks[:, text + i], cache,
                                   positions=pos[:, :, at:at + 1])
        outs.append(lg)
    full, _ = tf.forward(params, cfg, toks, pos, b["patch_embeds"])
    got = torch.stack(outs, dim=1)
    assert float((full[:, p + text - 1:] - got).abs().max()) < TOL
    jfull, _ = jtf.forward(jparams, jcfg, jb["tokens"], jb["positions"],
                           jb["patch_embeds"], remat=False)
    assert _err(jfull, full) < TOL


def test_serve_cli_counts_patch_positions(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
                "2", "--prompt-len", "10", "--gen", "3"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("serving qwen2-vl-smoke")
    report = json.loads(out[-1])
    assert report["prompt_len"] == 10 and report["patch_positions"] == 16
    run = serve.serve(ARCH, smoke=True, batch=2, prompt_len=10, gen=3,
                      device="cpu", verbose=False)
    want = jmake_batch(jget_smoke(ARCH), jax.random.PRNGKey(0), 2, 26,
                       with_labels=False)
    for name in ("tokens", "positions"):
        np.testing.assert_array_equal(run.prompt[name].numpy(),
                                      np.asarray(want[name]))
    assert run.result.cache["pos"] == 26 + 2
    assert tuple(run.prompt["patch_embeds"].shape) == \
        np.asarray(want["patch_embeds"]).shape
