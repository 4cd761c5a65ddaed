"""Deterministic synthetic token pipeline (``repro.data.pipeline``'s
counterpart).

Reproducible LM batches with a learnable signal: a noisy k-gram
structure, so loss falls during a training run (uniform noise would pin
the cross-entropy at log V).  ``SyntheticLM`` draws with numpy's
``default_rng`` exactly as the reference does, so its tokens and labels
are the reference's, bit for bit; codebook and patch-embedding configs
get ``make_batch`` under ``PRNGKey(step)``, the port's threefry, whose
integers are the reference's too.  ``host_batches`` yields the rows one
data-parallel host needs.  Batches are made on the host and moved to
``device``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.configs.shapes import make_batch
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Markov-ish synthetic corpus: x_{t+1} = (a * x_t + b) % V with
    noise."""

    vocab_size: int
    seq_len: int
    noise: float = 0.1
    seed: int = 0

    def arrays(self, step: int, batch_size: int) -> dict:
        """{"tokens", "labels"}: (B, S) int32 numpy arrays."""
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        v = self.vocab_size
        a = 6364136223846793005 % v or 1
        b = 1442695040888963407 % v
        x0 = rng.integers(0, v, size=(batch_size, 1))
        seq = [x0]
        for _ in range(self.seq_len):
            nxt = (a * seq[-1] + b) % v
            flip = rng.random((batch_size, 1)) < self.noise
            rand = rng.integers(0, v, size=(batch_size, 1))
            seq.append(np.where(flip, rand, nxt))
        arr = np.concatenate(seq, axis=1)  # (B, S+1)
        return {"tokens": arr[:, :-1].astype(np.int32),
                "labels": arr[:, 1:].astype(np.int32)}

    def batch(self, step: int, batch_size: int, device="cpu") -> dict:
        return {k: torch.as_tensor(v, device=device)
                for k, v in self.arrays(step, batch_size).items()}

    def batches(self, batch_size: int, num_steps: int,
                device="cpu") -> Iterator[dict]:
        for step in range(num_steps):
            yield self.batch(step, batch_size, device)


def batch_for_config(cfg: ModelConfig, step: int, batch_size: int,
                     seq_len: int, device="cpu") -> dict:
    """Synthetic batch matching the arch's input structure
    (codes / vision / text)."""
    if cfg.num_codebooks or cfg.num_patch_positions:
        return make_batch(cfg, rnd.PRNGKey(step, device), batch_size,
                          seq_len)
    return SyntheticLM(cfg.vocab_size, seq_len, seed=7).batch(
        step, batch_size, device)


def host_batches(cfg: ModelConfig, *, global_batch: int, seq_len: int,
                 num_steps: int, host_index: int = 0, num_hosts: int = 1,
                 device="cpu") -> Iterator[dict]:
    """This host's shard of each global batch (data-parallel rows): every
    tensor whose leading axis is the global batch is cut to the host's
    rows, the others pass whole (``positions``, (3, B, S), as in the
    reference)."""
    if global_batch % num_hosts:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{num_hosts} hosts")
    per_host = global_batch // num_hosts
    lo = host_index * per_host
    for step in range(num_steps):
        full = batch_for_config(cfg, step, global_batch, seq_len, device)
        yield {k: (a[lo:lo + per_host] if a.dim() and
                   a.shape[0] == global_batch else a)
               for k, a in full.items()}
