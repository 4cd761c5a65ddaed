#!/usr/bin/env python3
"""zamba2-1.2b's forward-vs-generated logit gap, reference against port.

    PYTHONPATH=src JAX_PLATFORMS=cpu python measure/zamba2_gap_cpu.py \
        [--layers 12] [--prompt 512] [--gen 32] [--dtype float32|float64] \
        [--out gap.json]

Serving prefills a prompt, then decodes token by token from the cache;
a teacher-forced forward over prompt + generated tokens should give the
same logits.  Their largest difference over the generated tokens is the
gap that ``chip_smoke.py`` holds to 1e-3.  This script measures it on the
CPU for both packages on the same weights: zamba2-1.2b at full width
(d_model 2048, 64 Mamba2 heads of 64, state 64, the shared attention
block) with its depth cut to ``--layers`` Mamba2 layers, batch 1,
random weights from the reference's ``init_params(PRNGKey(0))`` carried
over with ``repro_torch.convert.lm_params``, a prompt from the
reference's ``make_batch(PRNGKey(1))`` and greedy tokens.

``--dtype float32`` runs the reference (JAX, ``use_pallas`` off) and the
port (its plain kernels' versions, as on the CPU) and reports each gap
and how far the two packages' generated logits lie apart.
``--dtype float64`` runs the port alone in float64 throughout (weights,
activations, the SSD scan, and attention as a plain masked softmax in
place of the float32 flash version): what is left of the gap there is
not float32 rounding.  A full-depth run holds the reference's 1.2e9
parameters, the port's copy and, in float64, twice that; cut the depth
to what the host's memory allows.  Prints one JSON object and writes it
to ``--out`` when given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import resource
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.configs.shapes import make_batch as jmake_batch
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.ssd import ssd_plain
from repro_torch.models import mamba2 as m2
from repro_torch.models import transformer as tf
from repro_torch.serving.engine import generate

ARCH = "zamba2-1.2b"
CPU = torch.device("cpu")


def reference_gap(jcfg, jparams, tokens, gen: int) -> dict:
    """Prefill + greedy decode and the teacher-forced forward, in JAX."""
    p = tokens.shape[1]
    prefill = jax.jit(lambda w, x: jtf.prefill(w, jcfg, x,
                                               max_len=p + gen + 1))
    decode = jax.jit(lambda w, x, c: jtf.decode_step(w, jcfg, x, c))
    logits, cache = prefill(jparams, tokens)
    cur = jnp.argmax(logits, -1).astype(jnp.int32)
    toks, outs = [cur], [logits]
    for _ in range(gen - 1):
        logits, cache = decode(jparams, cur, cache)
        cur = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(cur)
        outs.append(logits)
    gen_tokens, gen_logits = jnp.stack(toks, 1), jnp.stack(outs, 1)
    seq = jnp.concatenate([tokens, gen_tokens[:, :-1]], 1)
    full, _ = jax.jit(lambda w, x: jtf.forward(w, jcfg, x, remat=False))(
        jparams, seq)
    diff = jnp.abs(full[:, p - 1:] - gen_logits)
    return dict(gap=float(diff.max()), gap_prefill_token=float(
        diff[:, 0].max()), gap_by_token=np.asarray(diff.max(-1))[0].tolist(),
        tokens=np.asarray(gen_tokens), logits=np.asarray(gen_logits))


def port_gap(params, cfg, tokens: torch.Tensor, gen: int) -> dict:
    p = tokens.shape[1]
    with torch.inference_mode():
        res = generate(params, cfg, {"tokens": tokens}, steps=gen)
        seq = torch.cat([tokens, res.tokens[:, :-1]], 1)
        full, _ = tf.forward(params, cfg, seq)
    diff = (full[:, p - 1:] - res.logits).abs()
    return dict(gap=float(diff.max()), gap_prefill_token=float(
        diff[:, 0].max()), gap_by_token=diff.amax(-1)[0].tolist(),
        tokens=res.tokens.numpy(), logits=res.logits.numpy())


def attention_float64(q, k, v, *, causal=True, window=0, scale=None):
    """Masked softmax attention in q's dtype, (B, S, H, D) layouts."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    qh = q.permute(0, 2, 1, 3)
    kh, vh = (t.permute(0, 2, 1, 3).repeat_interleave(h // kv, 1)
              for t in (k, v))
    s = (qh @ kh.transpose(-1, -2)) * scale
    rows = torch.arange(sq)[:, None] + (sk - sq)
    cols = torch.arange(sk)[None, :]
    ok = cols <= rows if causal else torch.ones_like(cols <= rows)
    if window:
        ok &= cols > rows - window
    s = s.masked_fill(~ok, float("-inf"))
    return (torch.softmax(s, -1) @ vh).permute(0, 2, 1, 3)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float32")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    jcfg = dataclasses.replace(jget_config(ARCH), n_layers=args.layers)
    cfg = dataclasses.replace(get_config(ARCH), n_layers=args.layers)
    t0 = time.perf_counter()
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = jmake_batch(jcfg, jax.random.PRNGKey(1), 1, args.prompt,
                         with_labels=False)["tokens"]
    out = dict(arch=ARCH, n_layers=args.layers, batch=1,
               prompt=args.prompt, gen=args.gen, dtype=args.dtype,
               params=cfg.num_params())
    ttokens = torch.as_tensor(np.array(tokens))
    if args.dtype == "float32":
        ref = reference_gap(jcfg, jparams, tokens, args.gen)
        host = jax.tree.map(np.asarray, jparams)
        del jparams
        port = port_gap(convert.lm_params(host, cfg, CPU), cfg, ttokens,
                        args.gen)
        out.update(
            reference_gap=ref["gap"],
            reference_gap_prefill_token=ref["gap_prefill_token"],
            reference_gap_by_token=ref["gap_by_token"],
            port_gap=port["gap"],
            port_gap_prefill_token=port["gap_prefill_token"],
            port_gap_by_token=port["gap_by_token"],
            generated_logits_apart=float(np.abs(
                port["logits"] - ref["logits"]).max()),
            same_tokens=bool((port["tokens"] == ref["tokens"]).all()),
            max_abs_logit=float(np.abs(ref["logits"]).max()))
    else:
        host = jax.tree.map(
            lambda a: np.asarray(a, np.float64)
            if np.asarray(a).dtype == np.float32 else np.asarray(a),
            jparams)
        del jparams
        cfg = dataclasses.replace(cfg, param_dtype="float64",
                                  compute_dtype="float64")
        params = convert.lm_params(host, cfg, CPU)
        del host
        # the port keeps some steps in float32 on purpose (norms, gates,
        # softplus, the decode attention, the flash version): widen them
        float_ = torch.Tensor.float
        torch.Tensor.float = lambda self, *a, **k: self.to(torch.float64)
        scan, attn = m2.ssd, tf.flash_attention
        m2.ssd = ssd_plain
        tf.flash_attention = attention_float64
        try:
            port = port_gap(params, cfg, ttokens, args.gen)
        finally:
            torch.Tensor.float = float_
            m2.ssd, tf.flash_attention = scan, attn
        if port["logits"].dtype != np.float64:
            raise RuntimeError("the float64 run did not stay in float64")
        out.update(port_gap=port["gap"],
                   port_gap_prefill_token=port["gap_prefill_token"],
                   port_gap_by_token=port["gap_by_token"])
    out["seconds"] = time.perf_counter() - t0
    out["max_rss_gb"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 1e6
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
