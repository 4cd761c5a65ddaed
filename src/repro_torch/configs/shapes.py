"""Concrete prompt batches (``repro.configs.shapes.make_batch``, text-only
branch).

Tokens are drawn with the port's threefry ``randint``, so the same key
gives the same prompt as the reference.  Multi-codebook and
patch-embedding batches belong to the slices that port those models.
"""
from __future__ import annotations

import torch

from repro_torch import random as rnd
from repro_torch.models.config import ModelConfig


def make_batch(cfg: ModelConfig, key: torch.Tensor, b: int, s: int, *,
               with_labels: bool = True) -> dict:
    """{"tokens": (B, S) int32[, "labels": (B, S) int32]} on the key's
    device, as the reference draws them from ``split(key, 3)``."""
    if cfg.num_codebooks or cfg.num_patch_positions:
        raise NotImplementedError(
            "codebook and patch-embedding batches are not ported yet "
            "(ROADMAP.md queue 1 item 10)")
    k1, k2, _ = rnd.split(key, 3)
    batch = {"tokens": rnd.randint(k1, (b, s), 0, cfg.vocab_size)}
    if with_labels:
        batch["labels"] = rnd.randint(k2, (b, s), 0, cfg.vocab_size)
    return batch
