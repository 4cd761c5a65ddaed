"""LM serving launcher of the port: prefill + batched autoregressive decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --smoke --batch 4 --prompt-len 32 --gen 16 [--device cuda]

The reference's flags plus ``--device`` (default ``cuda``; a missing card
raises).  Weights come from ``torch.Generator(device).manual_seed(0)``;
the prompt from ``make_batch`` under ``PRNGKey(0)`` and categorical draws
under ``PRNGKey(1)``, the reference CLI's keys.  A config with patch
positions (qwen2-vl-7b) gets ``--prompt-len`` text tokens after its patch
embeddings, as the reference CLI sizes it.  The last line printed is the
report as JSON.
"""
from __future__ import annotations

import argparse
import json
from typing import NamedTuple

import torch

from repro_torch import random as rnd
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.shapes import make_batch
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import GenerationResult, generate


class ServeRun(NamedTuple):
    cfg: ModelConfig
    params: tf.LM
    prompt: dict
    result: GenerationResult
    report: dict


def device_name(dev: torch.device) -> str:
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "CPU")


def serve(arch: str = "yi-6b", *, smoke: bool = False, **kw) -> ServeRun:
    """Serve ``arch``'s published config (or its smoke config): the CLI's
    path; ``kw`` as :func:`serve_config`'s."""
    return serve_config(get_smoke_config(arch) if smoke
                        else get_config(arch), **kw)


def serve_config(cfg: ModelConfig, *, batch: int = 4, prompt_len: int = 32,
                 gen: int = 16, sample: str = "greedy",
                 temperature: float = 0.8, device="cuda",
                 verbose: bool = True) -> ServeRun:
    """Build the model of ``cfg`` on ``device``, draw a prompt and generate
    ``gen`` tokens per sequence.  The report holds the timings (device
    synchronised) and the generated tokens."""
    dev = resolve_device(device)
    if verbose:
        print(f"serving {cfg.name} ({cfg.num_params() / 1e6:.1f}M params) "
              f"on {device_name(dev)}", flush=True)
    params = tf.init_params(cfg, seed=0, device=dev)
    plen = prompt_len + cfg.num_patch_positions
    prompt = make_batch(cfg, rnd.PRNGKey(0, dev), batch, plen,
                        with_labels=False)
    res = generate(params, cfg, prompt, steps=gen, sample=sample,
                   temperature=temperature, key=rnd.PRNGKey(1, dev))
    n_tok = batch * gen
    total_s = res.prefill_s + res.decode_s
    report = {
        "arch": cfg.name, "params": cfg.num_params(), "device": str(dev),
        "device_name": device_name(dev), "batch": batch,
        "prompt_len": prompt_len,
        "patch_positions": cfg.num_patch_positions, "gen": gen,
        "sample": sample,
        "prefill_ms": res.prefill_s * 1e3,
        "decode_ms_per_token": (res.decode_s * 1e3 / (gen - 1)
                                if gen > 1 else None),
        "tokens_per_s": n_tok / total_s,
        "decode_tokens_per_s": (batch * (gen - 1) / res.decode_s
                                if gen > 1 else None),
        "tokens": res.tokens.cpu().tolist(),
    }
    if verbose:
        print(f"generated {n_tok} tokens in {total_s:.2f}s "
              f"({report['tokens_per_s']:.1f} tok/s on "
              f"{report['device_name']}; prefill {report['prefill_ms']:.1f} "
              f"ms)")
        print("sample:", report["tokens"][0][:16])
    return ServeRun(cfg, params, prompt, res, report)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="yi-6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--sample", choices=("greedy", "categorical"),
                    default="greedy")
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run = serve(args.arch, smoke=args.smoke, batch=args.batch,
                prompt_len=args.prompt_len, gen=args.gen,
                sample=args.sample, temperature=args.temperature,
                device=args.device)
    print(json.dumps(run.report))


if __name__ == "__main__":
    main()
