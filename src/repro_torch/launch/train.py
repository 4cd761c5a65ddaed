"""LM training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \
        --steps 50 --batch 8 --seq 64 [--device cuda] [--ckpt state.msgpack]

The reference CLI's flags plus ``--device`` (default ``cuda``; a missing
card raises): weights from ``torch.Generator(device).manual_seed(0)``,
``adamw(cosine_with_warmup(lr, 20, steps))``, per-layer recomputation,
``--grad-accum`` microbatches, batches from ``batch_for_config`` (the
synthetic corpus; ``make_batch`` under ``PRNGKey(step)`` for codebook and
vision configs).  It prints the reference's lines (a loss line every 10
steps and at the last) and, last, a JSON report: losses and gradient
norms of every step, ms a step and tokens (positions) a second from the
second step on, device synchronised, and the peak device memory.
``--ckpt`` writes the final ``TrainState``
(``repro_torch.checkpoint.ckpt.save_train_state``).  ``--mesh`` belongs
to the multi-card slice and raises.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import NamedTuple

import torch

from repro_torch.checkpoint.ckpt import save_train_state
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.pipeline import batch_for_config
from repro_torch.device import resolve_device, synchronize
from repro_torch.launch.serve import device_name
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import adamw
from repro_torch.training.schedule import cosine_with_warmup
from repro_torch.training.train_step import (TrainState, init_train_state,
                                             make_train_step)

MESH_LATER = ("--mesh trains on a device mesh, which belongs to the "
              "multi-card slice: not ported yet (ROADMAP.md queue 1 item "
              "10.5)")
WARMUP_STEPS = 20


class TrainRun(NamedTuple):
    cfg: ModelConfig
    state: TrainState
    metrics: list        # per step: {"loss", "ce", "aux", "grad_norm"}
    report: dict


def train(arch: str = "yi-6b", *, smoke: bool = False, **kw) -> TrainRun:
    """Train ``arch``'s published config (or its smoke config): the CLI's
    path; ``kw`` as :func:`train_config`'s."""
    return train_config(get_smoke_config(arch) if smoke
                        else get_config(arch), **kw)


def train_config(cfg: ModelConfig, *, steps: int = 100, batch: int = 8,
                 seq: int = 64, lr: float = 3e-4, grad_accum: int = 1,
                 remat: bool = True, ckpt: str | None = None,
                 device="cuda", verbose: bool = True) -> TrainRun:
    """Train ``cfg`` from fresh weights on ``device`` for ``steps`` steps
    of ``batch`` sequences of ``seq`` positions."""
    dev = resolve_device(device)
    if verbose:
        print(f"training {cfg.name}: {cfg.num_params() / 1e6:.1f}M params "
              f"on {device_name(dev)}", flush=True)
    opt = adamw(lr=cosine_with_warmup(lr, WARMUP_STEPS, steps))
    state = init_train_state(cfg, opt, seed=0, device=dev)
    step_fn = make_train_step(cfg, opt, remat=remat, grad_accum=grad_accum)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    history = []
    t0 = time.perf_counter()
    t1 = None
    for i in range(steps):
        state, m = step_fn(state, batch_for_config(cfg, i, batch, seq, dev))
        history.append(m)
        if i == 0:
            synchronize(dev)
            t1 = time.perf_counter()
        if verbose and (i % 10 == 0 or i == steps - 1):
            print(f"step {i:4d} loss={float(m['loss']):.4f} "
                  f"gnorm={float(m['grad_norm']):.2f} "
                  f"[{time.perf_counter() - t0:.0f}s]", flush=True)
    synchronize(dev)
    t2 = time.perf_counter()
    metrics = [{k: float(v) for k, v in m.items()} for m in history]
    timed = steps - 1
    report = {
        "arch": cfg.name, "params": cfg.num_params(), "n_layers":
        cfg.n_layers, "device": str(dev), "device_name": device_name(dev),
        "steps": steps, "batch": batch, "seq": seq, "grad_accum": grad_accum,
        "remat": remat, "lr": lr,
        "loss": [m["loss"] for m in metrics],
        "grad_norm": [m["grad_norm"] for m in metrics],
        "first_step_ms": (t1 - t0) * 1e3,
        "ms_per_step": (t2 - t1) * 1e3 / timed if timed else None,
        "tokens_per_s": batch * seq * timed / (t2 - t1) if timed else None,
        "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else None),
        "ckpt": ckpt,
    }
    if ckpt:
        save_train_state(ckpt, state)
        if verbose:
            print("saved →", ckpt)
    return TrainRun(cfg, state, metrics, report)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="yi-6b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--mesh", default=None,
                    help="data,model mesh shape (the multi-card slice)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError(MESH_LATER)
    run = train(args.arch, smoke=args.smoke, steps=args.steps,
                batch=args.batch, seq=args.seq, lr=args.lr,
                grad_accum=args.grad_accum, ckpt=args.ckpt,
                device=args.device)
    print(json.dumps(run.report))
    return run.report


if __name__ == "__main__":
    main()
