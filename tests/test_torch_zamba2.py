"""The port's zamba2 (Mamba2 blocks + the weight-shared attention block)
against the JAX reference on the CPU.

At the zamba2 smoke config (4 Mamba2 layers, the shared block after every
2, window 32), with the reference's weights carried across by
``convert.lm_params``: the segment plan and block order, the cache
layout, decode once the shared block's KV rings have wrapped (the
reference's ``S = window + 17`` case), decode from a zero cache, several
decode steps against the teacher-forced forward — logits within 1e-4 —
and the serving CLI.  ``tests/test_torch_lm.py`` covers the prefill,
decode and forward logits, generation token for token, prompts and
configs for zamba2 with the other ported archs.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.configs.shapes import make_batch as jmake_batch
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import transformer as tf

CPU = torch.device("cpu")
ARCH = "zamba2-1.2b"
TOL = 1e-4


def _both(seed=0):
    jcfg, cfg = jget_smoke(ARCH), get_smoke_config(ARCH)
    jparams = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    params = convert.lm_params(jax.tree.map(np.asarray, jparams), cfg, CPU)
    return jcfg, jparams, cfg, params


def _tokens(jcfg, seed, b, s):
    return jmake_batch(jcfg, jax.random.PRNGKey(seed), b, s,
                       with_labels=False)["tokens"]


def _err(a, b):
    return float(np.abs(np.asarray(a) - b.numpy()).max())


@pytest.mark.parametrize("smoke", [False, True])
def test_segment_plan_and_schedule_match(smoke):
    jcfg = jget_smoke(ARCH) if smoke else jget_config(ARCH)
    cfg = get_smoke_config(ARCH) if smoke else get_config(ARCH)
    assert tf.segment_plan(cfg) == jtf.segment_plan(jcfg)
    assert tf.n_shared_applications(cfg) == jtf.n_shared_applications(jcfg)
    order = tf.layer_schedule(cfg)
    assert [i for kind, i in order if kind == "layer"] == list(
        range(cfg.n_layers))
    assert [i for kind, i in order if kind == "shared"] == list(
        range(tf.n_shared_applications(cfg)))
    # the shared block runs after each full group of shared_attn_every
    every = cfg.shared_attn_every
    for pos, (kind, j) in enumerate(order):
        if kind == "shared":
            assert order[pos - 1] == ("layer", (j + 1) * every - 1)
    if not smoke:
        assert tf.segment_plan(cfg) == [("mamba2", 6)] * 6 + [("mamba2", 2)]
        assert order[-2:] == [("layer", 36), ("layer", 37)]


def test_cache_layout_matches_the_reference():
    jcfg, cfg = jget_smoke(ARCH), get_smoke_config(ARCH)
    jc = jtf.init_cache(jcfg, 2, 40)
    c = tf.init_cache(cfg, 2, 40, device=CPU)
    flat = [layer for seg in jc["segments"] for layer in
            ({k: v[i] for k, v in seg.items()}
             for i in range(seg["conv"].shape[0]))]
    assert len(c["layers"]) == len(flat) == cfg.n_layers
    for mine, theirs in zip(c["layers"], flat):
        assert {k: tuple(v.shape) for k, v in mine.items()} == \
            {k: tuple(v.shape) for k, v in theirs.items()}
    assert len(c["shared"]) == jc["shared"]["k"].shape[0]
    for ring in c["shared"]:
        # capacity min(max_len, window) = 32
        assert tuple(ring["k"].shape) == jc["shared"]["k"].shape[1:]
        assert ring["k"].shape[1] == cfg.sliding_window


def test_lm_needs_its_shared_block():
    _, _, cfg, params = _both()
    with pytest.raises(ValueError, match="shared_block"):
        tf.LM(cfg, {"tok": params.embed["tok"].data},
              {"scale": params.final_norm["scale"].data},
              list(params.blocks), params.lm_head.data)
    assert sum(p.numel() for p in params.parameters()) == cfg.num_params()


def test_ring_cache_past_the_window():
    """Decode once every shared-block ring has wrapped (pos > window)."""
    jcfg, jparams, cfg, params = _both(seed=1)
    s = cfg.sliding_window + 17
    toks = _tokens(jcfg, 1, 2, s)
    t = torch.as_tensor(np.array(toks))
    jfull, _ = jtf.forward(jparams, jcfg, toks, remat=False)
    lg_pre, cache = tf.prefill(params, cfg, t[:, :s - 1], max_len=s + 4)
    assert len(cache["shared"]) == tf.n_shared_applications(cfg)
    assert cache["shared"][0]["k"].shape[1] == cfg.sliding_window
    assert _err(jfull[:, s - 2], lg_pre) < TOL
    lg, cache = tf.decode_step(params, cfg, t[:, s - 1], cache)
    assert _err(jfull[:, s - 1], lg) < TOL and cache["pos"] == s


def test_decode_from_a_zero_cache_matches():
    jcfg, jparams, cfg, params = _both(seed=4)
    toks = _tokens(jcfg, 4, 2, 1)
    cache = tf.init_cache(cfg, 2, 8, device=CPU)
    lg, cache = tf.decode_step(params, cfg, torch.as_tensor(
        np.array(toks[:, 0])), cache)
    jlg, _ = jtf.decode_step(jparams, jcfg, toks[:, 0],
                             jtf.init_cache(jcfg, 2, 8))
    assert _err(jlg, lg) < TOL and cache["pos"] == 1


def test_multi_step_decode_tracks_forward():
    jcfg, jparams, cfg, params = _both(seed=2)
    s, n_dec = 45, 6  # the decode steps cross the window (32)
    toks = _tokens(jcfg, 2, 2, s)
    t = torch.as_tensor(np.array(toks))
    jfull, _ = jtf.forward(jparams, jcfg, toks, remat=False)
    full, _ = tf.forward(params, cfg, t)
    assert _err(jfull, full) < TOL
    _, cache = tf.prefill(params, cfg, t[:, :s - n_dec], max_len=s + 2)
    for i in range(n_dec):
        pos = s - n_dec + i
        lg, cache = tf.decode_step(params, cfg, t[:, pos], cache)
        assert _err(jfull[:, pos], lg) < TOL, i


def test_serve_cli_runs_zamba2_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
                "2", "--prompt-len", "40", "--gen", "3"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("serving zamba2-smoke") and "on CPU" in out[0]
    report = json.loads(out[-1])
    assert report["params"] == get_smoke_config(ARCH).num_params()
    assert np.asarray(report["tokens"]).shape == (2, 3)
