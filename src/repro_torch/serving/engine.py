"""LM serving engine: prefill + decode-step factories and batched
generation (``repro.serving.engine``'s counterpart).

Runs eagerly on the device of the weights.  Sampling follows the
reference key schedule — ``key, k0 = split(key)`` before the first token
and ``key, ki = split(key)`` before each later one — with the port's
threefry, so a categorical run draws the reference's uniforms.  With
codebooks (musicgen) a token is (B, K): greedy and sampled picks take the
argmax or the categorical draw over the last axis of (B, K, V) logits.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import torch

from repro_torch import random as rnd
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig


def make_prefill(cfg: ModelConfig):
    def prefill_step(params, batch, max_len):
        return tf.prefill(params, cfg, batch["tokens"],
                          positions=batch.get("positions"),
                          patch_embeds=batch.get("patch_embeds"),
                          max_len=max_len)
    return prefill_step


def _pick(logits, sample: str, temperature: float, key):
    if sample == "greedy":
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if key is None:
        raise ValueError("categorical sampling needs a key")
    return rnd.categorical(key, logits.float() / temperature).to(torch.int32)


def make_serve_step(cfg: ModelConfig, *, sample: str = "greedy",
                    temperature: float = 1.0):
    """(params, token, cache[, key]) → (next_token, logits, cache); the
    cache is updated in place."""
    if sample not in ("greedy", "categorical"):
        raise ValueError(f"unknown sampling {sample!r}")

    def serve_step(params, token, cache, key=None):
        logits, cache = tf.decode_step(params, cfg, token, cache)
        return _pick(logits, sample, temperature, key), logits, cache

    return serve_step


class GenerationResult(NamedTuple):
    tokens: torch.Tensor   # (B, steps) or (B, K, steps) int32
    cache: dict
    # (B, steps, V) or (B, steps, K, V): the logits each token came from
    logits: torch.Tensor
    prefill_s: float       # prompt → first token, device synchronised
    decode_s: float        # the steps - 1 decode steps, synchronised


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def generate(params, cfg: ModelConfig, prompt_batch: dict, *, steps: int,
             max_len: int | None = None, sample: str = "greedy",
             temperature: float = 1.0, key=None) -> GenerationResult:
    """Prefill the prompt (with its positions and patch embeds, when it
    has them), then decode ``steps - 1`` more tokens (``steps`` in all,
    the first from the prefill logits).

    The cache holds ``max_len`` or, as in the reference, the text length
    + ``steps`` + 1 tokens: patch positions are not counted, so with
    patches a KV ring holds fewer slots than the prompt."""
    tokens = prompt_batch["tokens"]
    dev = tokens.device
    total = max_len or (tokens.shape[-1] + steps + 1)
    serve_step = make_serve_step(cfg, sample=sample, temperature=temperature)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = make_prefill(cfg)(params, prompt_batch, total)
    k0 = None
    if sample != "greedy":
        key, k0 = rnd.split(key, 2)
    cur = _pick(logits, sample, temperature, k0)
    _sync(dev)
    t1 = time.perf_counter()
    outs, all_logits = [cur], [logits]
    for _ in range(steps - 1):
        ki = None
        if sample != "greedy":
            key, ki = rnd.split(key, 2)
        cur, logits, cache = serve_step(params, cur, cache, ki)
        outs.append(cur)
        all_logits.append(logits)
    _sync(dev)
    t2 = time.perf_counter()
    return GenerationResult(torch.stack(outs, dim=-1), cache,
                            torch.stack(all_logits, dim=1), t1 - t0, t2 - t1)
