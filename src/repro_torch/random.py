"""Counter-based threefry2x32 keys, bit-equal to ``jax.random``.

The reference draws its background flags per *global* cell id through
``fold_in`` on every env step and splits its serving key every tick, so
request records only match it with background noise on if the port draws
the very same bits.  This module reproduces ``jax.random``'s default
threefry2x32 implementation under ``jax_threefry_partitionable=True``
(the default since jax 0.5):

    key            = (0, seed mod 2**32)                       PRNGKey
    split(key, n)  = [threefry(key, (0, i)) for i < n]
    fold_in(key,d) = threefry(key, (0, d))
    bits(key, s)   = y0 ^ y1 where (y0, y1) = threefry(key, (hi(i), lo(i)))
                     for every flat index i of shape s
    uniform        = bitcast((bits >> 9) | 0x3f800000) - 1.0   (float32)

Keys are int64 tensors of shape ``(..., 2)`` holding 32-bit words (every
intermediate is masked to 32 bits), so leading axes batch independent
keys without ``vmap``.  ``torch.Generator`` stays the tool for fleet and
weight generation, where only statistical parity is asked for.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20-round threefry2x32 block function on broadcast int64 words
    (each holding a uint32).  Returns the two output words."""
    k0, k1, x0, x1 = torch.broadcast_tensors(k0, k1, x0, x1)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def PRNGKey(seed: int, device="cuda") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 32-bit seeds: ``(0, seed mod
    2**32)`` as a (2,) int64 tensor."""
    dev = resolve_device(device)
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=dev)


def _hash(key: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    """threefry(key, (0, counter)) stacked as keys: key (..., 2) against
    counters broadcast over its leading axes."""
    y0, y1 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(counter), counter)
    return torch.stack([y0, y1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(..., 2) key(s) → (..., num, 2) subkeys, as ``jax.random.split``."""
    ctr = torch.arange(num, dtype=torch.int64, device=key.device)
    return _hash(key[..., None, :], ctr)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` broadcast over ``data``: (..., 2) key and
    integer data (an int or a tensor) → (..., 2) keys."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK32
    return _hash(key, data)


def uniform_at(keys: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """float32 U[0, 1) draw number ``index`` (flat, row-major, < 2**32) of
    ``jax.random.uniform(key, shape)``, broadcast over (..., 2) ``keys``
    and ``index``.  Lets one threefry call serve draws of many keys."""
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(index), index)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32, [0, 1)) for (..., 2)
    keys → (..., *shape)."""
    shape = tuple(shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=key.device)
    u = uniform_at(key[..., None, :], idx)
    return u.reshape(key.shape[:-1] + shape)
