#!/usr/bin/env python3
"""How far float32 LM gradients lie from float64 ones, reference and
port, at the smoke configs of ``tests/test_torch_train_parity.py``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python measure/train_grad_f64_cpu.py \
        [--arch zamba2-1.2b] [--top 6]

The gradients of ``lm_loss`` at the reference's ``init_train_state
(PRNGKey(0))`` on the parity test's batch (B 2, S 24): the reference in
float32 and in float64 (JAX with x64 on, the config's dtypes float64),
and the port in float32 (weights carried with ``convert.lm_train_state``,
the plain kernels' versions, as on the CPU).  For each parameter leaf,
each float32 gradient's largest distance to the float64 one and the
two float32 gradients' distance to each other, over the leaf's largest
float64 magnitude; prints the ``--top`` leaves by the port's distance,
one JSON object each.  Where the reference's own float32 gradient lies
as far from float64 as the port's, the leaf's float32 rounding, not the
port, sets how close the two packages can agree.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))
from test_torch_train_parity import reference_batch  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.training import train_step as ts  # noqa: E402


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--top", type=int, default=6)
    args = ap.parse_args(argv)
    jcfg = jget_smoke(args.arch)
    jstate = jts.init_train_state(jax.random.PRNGKey(0), jcfg,
                                  jopt.sgd(0.05))
    batch = reference_batch(jcfg, 2, 24)

    def grads(cfg, params):
        return jax.jit(jax.grad(lambda p: jts.lm_loss(
            p, cfg, batch, remat=False)[0]))(params)

    to_np = lambda t: jax.tree.map(np.asarray, t)
    g32 = grads(jcfg, jstate.params)
    c64 = dataclasses.replace(jcfg, param_dtype="float64",
                              compute_dtype="float64")
    g64 = grads(c64, jax.tree.map(lambda a: a.astype(np.float64),
                                  jstate.params))
    cfg = get_smoke_config(args.arch)
    state = convert.lm_train_state(to_np(jstate), cfg, "cpu")
    tree = ts.param_tree(state.params)
    loss, _ = ts.lm_loss(state.params, cfg, {
        k: torch.as_tensor(np.array(v)) for k, v in batch.items()},
        remat=False)
    port = torch.autograd.grad(loss, list(tree.values()), allow_unused=True,
                               materialize_grads=True)
    ref32 = convert.lm_param_tree(to_np(g32), cfg, "cpu")
    # float64 leaves unstacked by the same mapping, kept in float64
    ref64 = {k: torch.as_tensor(np.asarray(v, np.float64)) for k, v in
             zip(ref32, _leaves_f64(g64, cfg))}
    rows = []
    for name, g in zip(tree, port):
        w = ref64[name]
        m = float(w.abs().max()) or 1e-30
        rows.append({
            "leaf": name,
            "port_f32_vs_f64": float((g.double() - w).abs().max()) / m,
            "ref_f32_vs_f64": float((ref32[name].double() - w).abs().max())
            / m,
            "port_vs_ref_f32": float((g - ref32[name]).abs().max()) / m})
    rows.sort(key=lambda r: r["port_f32_vs_f64"])
    for r in rows[-args.top:]:
        print(json.dumps(r))
    return rows


def _leaves_f64(tree, cfg) -> list:
    """The leaves of a reference params-shaped tree in the port's
    ``param_tree`` order, float64 kept (``convert.lm_param_tree`` maps
    through the port's float32 modules)."""
    lm = convert.lm_params(jax.tree.map(np.asarray, tree), cfg, "cpu")
    return [p.detach().numpy() for p in ts.param_tree(lm).values()]


if __name__ == "__main__":
    main()
