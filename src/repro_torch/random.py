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
    uniform        = max(lo, fma(u, hi - lo, lo)) in float32, where
                     u = bitcast((bits >> 9) | 0x3f800000) - 1.0
    randint        = lo + ((bits(k1) % span) * mult
                           + bits(k2) % span) % span,  (k1, k2) = split(key),
                     mult = (2**16 % span)**2 % span in wrapping uint32
                     (``maxval`` may be a device tensor: no host sync)
    normal         = sqrt(2) * erf_inv(uniform(key, shape, -1 + ulp/2, 1)),
                     erf_inv as XLA's single-precision polynomials
    gumbel         = -log(-log(max(uniform, tiny)))
    categorical    = argmax(logits + gumbel(key, logits.shape))
    poisson        = jax's two loops over the whole array from one key:
                     Knuth (lam < 10, split(key) per step) and Hormann's
                     transformed rejection (split(key, 3) per step)

``randint`` is bit-equal.  ``normal`` draws bit-equal uniforms and
evaluates XLA's ``erf_inv`` polynomials with each step rounded as the
fused multiply-add XLA emits; only PyTorch's float32 ``log1p`` rounds
apart, so about 1% of values differ, by at most a few 1e-7 (weights
drawn from it match the reference's to that).  ``gumbel`` draws
bit-equal uniforms, and its two logarithms are PyTorch's, which round
differently from XLA's in the last bit of about one value in seven, so
its values agree to a few float32 ulps (and ``categorical`` picks the same index unless two perturbed
logits tie to within that).

Keys are int64 tensors of shape ``(..., 2)`` holding 32-bit words (every
intermediate is masked to 32 bits), so leading axes batch independent
keys without ``vmap``.  ``poisson`` computes its logarithms and
``lgamma`` with PyTorch's float32 functions, as the reference does with
XLA's.  The two ``lgamma``s round apart in the last bits, which flips no
count at the stream's rates (lam up to 150, held bit-equal by
``tests/test_torch_random.py``) but flips some near lam 1e4.
``torch.Generator`` stays the tool for weight generation, where only
statistical parity is asked for.
"""
from __future__ import annotations

import math

import numpy as np
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
    bits = (bits_at(keys, index) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape=(), minval=0.0, maxval=1.0
            ) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=, maxval=)`` (float32,
    [minval, maxval)) for (..., 2) keys → (..., *shape)."""
    shape = tuple(shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=key.device)
    u = uniform_at(key[..., None, :], idx).reshape(key.shape[:-1] + shape)
    if minval == 0.0 and maxval == 1.0:
        return u  # u (1 - 0) + 0 is u itself
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    # XLA contracts u (hi - lo) + lo into one fused multiply-add; the
    # product of two float32 values is exact in float64, so the sum
    # there rounds as the fused form does
    fused = u.double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, fused.float())


def bits_at(keys: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The 32 random bits number ``index`` of ``jax.random.bits(key,
    shape)`` (flat, row-major, < 2**32), as int64, broadcast over (..., 2)
    ``keys`` and ``index``."""
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(index), index)
    return y0 ^ y1


def _bits(key: torch.Tensor, shape) -> torch.Tensor:
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=key.device)
    return bits_at(key[..., None, :], idx).reshape(key.shape[:-1] + shape)


def randint(key: torch.Tensor, shape, minval: int, maxval) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32) for one
    (2,) key and int32-range bounds.  ``maxval`` may be an int or an
    integer tensor on the key's device (broadcast to ``shape``, as a
    traced bound in the reference), which keeps the draw free of host
    syncs."""
    shape = tuple(shape)
    k1, k2 = split(key, 2)
    if isinstance(maxval, torch.Tensor):
        span = (maxval.to(torch.int64) - minval).clamp(min=1)
    else:
        span = maxval - minval if maxval > minval else 1
        if not 0 < span < 2 ** 32:
            raise ValueError(f"randint span {span} outside uint32")
    # the reference's 2**32 % span, squared in wrapping uint32
    mult = ((2 ** 16 % span) ** 2 & MASK32) % span
    # both keys' bits in one threefry call
    hi_bits, lo_bits = _bits(torch.stack([k1, k2]), shape)
    # every product and sum wraps at 32 bits, as the reference's uint32
    off = ((hi_bits % span) * mult) & MASK32
    off = ((off + lo_bits % span) & MASK32) % span
    return (off + minval).to(torch.int32)


# XLA's single-precision erf_inv (Giles' two polynomials in w = -log1p(-x²),
# split at w = 5), coefficients highest degree first
_ERF_INV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                -4.39150654e-06, 0.00021858087, -0.00125372503,
                -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function as XLA evaluates it: each Horner
    step ``c + p·w`` rounded once, as the fused multiply-add it compiles
    to (the product of two float32 values is exact in float64, so the
    float64 sum rounds as the fused form does); ±1 maps to ±max."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    # the coefficients as float32 values (exact in a Python float)
    f32 = lambda c: float(np.float32(c))
    coef = lambda i: torch.where(lt, f32(_ERF_INV_LT5[i]),
                                 f32(_ERF_INV_GE5[i]))
    p = coef(0)
    for i in range(1, len(_ERF_INV_LT5)):
        p = (coef(i).double() + p.double() * w).float()
    return torch.where(x.abs() == 1, x * torch.finfo(torch.float32).max,
                       p * x)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (float32): uniforms in
    (-1, 1) mapped through ``sqrt(2) · erf_inv``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return float(np.float32(math.sqrt(2))) * erf_inv(u)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` (float32, the default "low"
    mode): uniforms in [tiny, 1) mapped through ``-log(-log(u))``."""
    tiny = torch.finfo(torch.float32).tiny
    u = uniform(key, shape).clamp_min(tiny)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``: the Gumbel-max
    draw over the last axis (int64 indices)."""
    g = gumbel(key, tuple(logits.shape))
    return torch.argmax(g + logits, dim=-1)


def _poisson_knuth(key, lam, shape):
    """jax's ``_poisson_knuth``: multiply uniforms until their product
    falls to exp(-lam), every element of ``shape`` stepping together."""
    k = torch.zeros(shape, dtype=torch.int32, device=key.device)
    log_prod = torch.zeros(shape, dtype=torch.float32, device=key.device)
    while bool((log_prod > -lam).any()):
        key, sub = split(key, 2)
        k = torch.where(log_prod > -lam, k + 1, k)
        log_prod = log_prod + torch.log(uniform(sub, shape))
    return k - 1


def _poisson_rejection(key, lam, shape):
    """jax's ``_poisson_rejection`` (Hormann's transformed rejection).  As
    there, every step draws for the whole array and overwrites the result
    of every element that accepts, accepted before or not, until all have
    accepted: an element's count depends on how many steps the slowest
    one needs."""
    log_lam = torch.log(lam)
    b = 0.931 + 2.53 * torch.sqrt(lam)
    a = -0.059 + 0.02483 * b
    inv_alpha = 1.1239 + 1.1328 / (b - 3.4)
    v_r = 0.9277 - 3.6224 / (b - 2)
    k_out = torch.full(shape, -1.0, dtype=torch.float32, device=key.device)
    accepted = torch.zeros(shape, dtype=torch.bool, device=key.device)
    while not bool(accepted.all()):
        key, k0, k1 = split(key, 3)
        u = uniform(k0, shape) - 0.5
        v = uniform(k1, shape)
        u_shifted = 0.5 - torch.abs(u)
        k = torch.floor((2 * a / u_shifted + b) * u + lam + 0.43)
        s = torch.log(v * inv_alpha / (a / (u_shifted * u_shifted) + b))
        t = -lam + k * log_lam - torch.lgamma(k + 1)
        accept1 = (u_shifted >= 0.07) & (v <= v_r)
        reject = (k < 0) | ((u_shifted < 0.013) & (v > u_shifted))
        accept = accept1 | (~reject & (s <= t))
        k_out = torch.where(accept, k, k_out)
        accepted |= accept
    return k_out.to(torch.int32)


def poisson(key: torch.Tensor, lam, shape=None) -> torch.Tensor:
    """``jax.random.poisson(key, lam, shape)`` (int32) for one (2,) key:
    ``lam`` (broadcast to ``shape``) is cast to float32; elements with
    lam < 10 (or NaN) take Knuth's count and the others the rejection
    sampler's, both run over the whole array from ``key``; lam = 0 gives
    0."""
    lam = torch.as_tensor(lam, device=key.device)
    shape = tuple(lam.shape) if shape is None else tuple(shape)
    lam = torch.broadcast_to(lam, shape).to(torch.float32)
    use_knuth = torch.isnan(lam) | (lam < 10)
    knuth = _poisson_knuth(key, torch.where(use_knuth, lam, 0.0), shape)
    rejection = _poisson_rejection(
        key, torch.where(use_knuth, 1e5, lam), shape)
    out = torch.where(use_knuth, knuth, rejection)
    return torch.where(lam == 0, 0, out)
