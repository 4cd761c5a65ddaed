"""Concrete batches (``repro.configs.shapes.make_batch``: the text,
codebook and patch-embedding branches).

Tokens are drawn with the port's threefry ``randint``, so the same key
gives the same batch as the reference; patch embeddings with its
``normal``, which differs from ``jax.random.normal`` in the last bit of
about 1% of values (tests carry the reference's across).
"""
from __future__ import annotations

import torch

from repro_torch import random as rnd
from repro_torch.models.config import ModelConfig


def mrope_positions(p: int, s: int, b: int, device) -> torch.Tensor:
    """(3, B, S) int32 M-RoPE positions of ``p`` patch positions on a
    square (t = 0, h, w) grid followed by ``s - p`` text positions, which
    count on from the grid's side on all three rows."""
    side = int(p ** 0.5)
    idx = torch.arange(p, dtype=torch.int32, device=device)
    text = torch.arange(side, side + (s - p), dtype=torch.int32,
                        device=device)
    pos = torch.stack([torch.cat([torch.zeros_like(idx), text]),
                       torch.cat([idx // side, text]),
                       torch.cat([idx % side, text])])
    return pos[:, None].expand(3, b, s)


def make_batch(cfg: ModelConfig, key: torch.Tensor, b: int, s: int, *,
               with_labels: bool = True) -> dict:
    """On the key's device, as the reference draws them from ``split(key,
    3)``: {"tokens": (B, S) int32[, "labels": (B, S) int32]}; with patch
    positions P, S counts them: {"tokens": (B, S - P), "patch_embeds":
    (B, P, D), "positions": (3, B, S)[, "labels": (B, S)]}; with K
    codebooks tokens and labels are (B, K, S)."""
    k1, k2, k3 = rnd.split(key, 3)
    if cfg.num_codebooks:
        shape = (b, cfg.num_codebooks, s)
        batch = {"tokens": rnd.randint(k1, shape, 0, cfg.vocab_size)}
        if with_labels:
            batch["labels"] = rnd.randint(k2, shape, 0, cfg.vocab_size)
        return batch
    if not cfg.num_patch_positions:
        batch = {"tokens": rnd.randint(k1, (b, s), 0, cfg.vocab_size)}
        if with_labels:
            batch["labels"] = rnd.randint(k2, (b, s), 0, cfg.vocab_size)
        return batch
    p = cfg.num_patch_positions
    if s <= p:
        raise ValueError(f"a batch of {s} positions leaves no text after "
                         f"{p} patch positions")
    batch = {"tokens": rnd.randint(k1, (b, s - p), 0, cfg.vocab_size),
             "patch_embeds": (0.02 * rnd.normal(k3, (b, p, cfg.d_model)))
             .to(cfg.compute_torch_dtype),
             "positions": mrope_positions(p, s, b, key.device)}
    if with_labels:
        batch["labels"] = rnd.randint(k2, (b, s), 0, cfg.vocab_size)
    return batch
