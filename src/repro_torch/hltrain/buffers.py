"""Fixed-capacity replay buffers on device tensors.

Counterpart of ``repro.hltrain.buffers``: the three Algorithm-1 buffers —
D_direct (prioritized), D_world (uniform) and D_plan (prioritized, with
hashed (s, a) novelty) — with the reference's semantics and draws:

  * **Batched ring writes.**  One fleet step writes its C transitions at
    consecutive ring slots in one scatter per field.  A boolean ``mask``
    keeps the rows that land (novel plan entries), compacted so that B
    rows advance the cursor by ``mask.sum()``; the others go to a trash
    row at index ``capacity``.  Every field holds ``capacity + 1`` rows
    for it (the reference drops such writes with ``mode="drop"``, which
    PyTorch lacks); the trash row is never sampled, since draws stay
    below ``size <= capacity``.
  * **Prioritized sampling** by a Gumbel top-k over α·log p_i of the
    written slots (Schaul et al.'s P(i) ∝ p_i^α), importance weights
    (N·P(i))^−β normalised by the batch's max; the batch in descending
    order of the perturbed logits, as ``jax.lax.top_k`` gives it.
  * **Hashed novelty for D_plan**: 32-bit multiply-xor keys of the
    3-decimal-quantised state and the action, in unsigned 32-bit
    arithmetic carried in int64 (every product and sum masked to 32
    bits).  Membership sorts the written keys and binary-searches the
    queries: the reference's dense O(B·cap) compare, in O((B + cap)
    log cap) memory-light work.

Buffers are NamedTuples of tensors.  Writes and priority updates go into
the tensors in place (one carry per trainer: a copy of a 500k-row ring
per step would cost more than the step), and return the buffer with its
new cursor and size.  Cursors, sizes and readiness stay device values, so
no function here syncs with the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import random as rnd
from repro_torch.device import resolve_device
from repro_torch.random import MASK32


class Ring(NamedTuple):
    """Uniform ring of (s, a, r, s', done) with its write cursor; every
    field has ``capacity + 1`` rows, the last a trash row."""
    s: torch.Tensor      # (cap + 1, D) float32
    a: torch.Tensor      # (cap + 1,)  int32
    r: torch.Tensor      # (cap + 1,)  float32
    s2: torch.Tensor     # (cap + 1, D) float32
    done: torch.Tensor   # (cap + 1,)  float32
    ptr: torch.Tensor    # ()          int32 — next write slot
    size: torch.Tensor   # ()          int32 — slots written (≤ cap)

    @property
    def capacity(self) -> int:
        return self.a.shape[0] - 1


class PrioRing(NamedTuple):
    """Prioritized ring: Schaul et al. priorities over ``ring``'s slots."""
    ring: Ring
    prio: torch.Tensor      # (cap + 1,) float32 — p_i = |td| + eps
    max_prio: torch.Tensor  # ()         float32 — new samples' priority


class PlanRing(NamedTuple):
    """D_plan: prioritized ring + 32-bit (s, a) membership keys."""
    buf: PrioRing
    keys: torch.Tensor  # (cap + 1,) int64 holding uint32 keys


# ------------------------------------------------------------------ uniform
def ring_init(capacity: int, state_dim: int, device="cuda") -> Ring:
    dev = resolve_device(device)
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev)
    rows = capacity + 1
    return Ring(z((rows, state_dim), torch.float32), z((rows,), torch.int32),
                z((rows,), torch.float32), z((rows, state_dim), torch.float32),
                z((rows,), torch.float32), z((), torch.int32),
                z((), torch.int32))


def _write_slots(ptr, capacity: int, n_rows: int, mask=None):
    """Ring slots of the masked-in rows (consecutive from ``ptr``) and how
    many land; masked-out rows map to the trash row ``capacity``.  A batch
    wider than the ring would write two rows to one slot, so it is
    refused — size buffers to at least one fleet's width."""
    if n_rows > capacity:
        raise ValueError(
            f"batched write of {n_rows} rows exceeds buffer capacity "
            f"{capacity}; raise the buffer cap to at least the fleet's "
            f"cell count")
    if mask is None:
        rows = torch.arange(n_rows, device=ptr.device)
        return (ptr + rows) % capacity, n_rows
    offset = torch.cumsum(mask.to(torch.int64), 0) - 1
    idx = torch.where(mask, (ptr + offset) % capacity, capacity)
    return idx, mask.sum(dtype=torch.int32)


def _ring_put(buf: Ring, idx, n_new, s, a, r, s2, done) -> Ring:
    buf.s.index_copy_(0, idx, s.to(torch.float32))
    buf.a.index_copy_(0, idx, a.to(torch.int32))
    buf.r.index_copy_(0, idx, r.to(torch.float32))
    buf.s2.index_copy_(0, idx, s2.to(torch.float32))
    buf.done.index_copy_(0, idx, done.to(torch.float32))
    cap = buf.capacity
    return buf._replace(ptr=((buf.ptr + n_new) % cap).to(torch.int32),
                        size=(buf.size + n_new).clamp(max=cap).to(
                            torch.int32))


def ring_add(buf: Ring, s, a, r, s2, done, mask=None) -> Ring:
    """Write a batch of B transitions at consecutive ring slots."""
    idx, n_new = _write_slots(buf.ptr, buf.capacity, a.shape[0], mask)
    return _ring_put(buf, idx, n_new, s, a, r, s2, done)


def _gather(buf: Ring, idx):
    return (buf.s[idx], buf.a[idx], buf.r[idx], buf.s2[idx], buf.done[idx])


def ring_sample(buf: Ring, key, batch: int):
    """Uniform minibatch over the written slots, indices drawn below
    ``max(size, 1)`` (a device bound: no host sync).  Returns (batch,
    idx)."""
    idx = rnd.randint(key, (batch,), 0, buf.size.clamp(min=1))
    return _gather(buf, idx.long()), idx


# -------------------------------------------------------------- prioritized
def prio_init(capacity: int, state_dim: int, device="cuda") -> PrioRing:
    ring = ring_init(capacity, state_dim, device)
    dev = ring.a.device
    return PrioRing(ring,
                    torch.zeros((capacity + 1,), dtype=torch.float32,
                                device=dev),
                    torch.ones((), dtype=torch.float32, device=dev))


def _prio_put(buf: PrioRing, idx, n_new, s, a, r, s2, done) -> PrioRing:
    buf.prio.index_copy_(0, idx, buf.max_prio.expand(idx.shape[0]))
    return buf._replace(ring=_ring_put(buf.ring, idx, n_new, s, a, r, s2,
                                       done))


def prio_add(buf: PrioRing, s, a, r, s2, done, mask=None) -> PrioRing:
    """Ring write; new samples enter at the running max priority."""
    idx, n_new = _write_slots(buf.ring.ptr, buf.ring.capacity, a.shape[0],
                              mask)
    return _prio_put(buf, idx, n_new, s, a, r, s2, done)


def prio_sample(buf: PrioRing, key, batch: int, *, alpha: float = 0.6,
                beta: float = 0.4):
    """Gumbel-top-k prioritized minibatch.  Returns (batch, idx, weights).

    Only written slots carry finite logits, so whenever size ≥ batch the
    draw never returns an unwritten slot."""
    ring = buf.ring
    cap = ring.capacity
    written = torch.arange(cap, device=ring.a.device) < ring.size
    prio = buf.prio[:cap]
    neg_inf = float("-inf")
    logp = torch.where(written, alpha * torch.log(prio + 1e-12), neg_inf)
    gumbel = rnd.gumbel(key, (cap,))
    idx = torch.topk(torch.where(written, logp + gumbel, neg_inf), batch,
                     sorted=True).indices
    p_alpha = torch.where(written, prio, 0.0) ** alpha
    probs = p_alpha / p_alpha.sum().clamp(min=1e-12)
    w = (ring.size.clamp(min=1) * probs[idx]) ** (-beta)
    w = (w / w.max().clamp(min=1e-12)).to(torch.float32)
    return _gather(ring, idx), idx, w


def prio_update(buf: PrioRing, idx, td_errors, mask=None) -> PrioRing:
    """Set priorities |td| + 1e-4 at ``idx`` (masked-out rows go to the
    trash row)."""
    p = torch.abs(td_errors).to(torch.float32) + 1e-4
    if mask is None:
        slots, landed = idx, p
    else:
        slots = torch.where(mask, idx, buf.ring.capacity)
        landed = torch.where(mask, p, 0.0)
    buf.prio.index_copy_(0, slots.long(), p)
    return buf._replace(max_prio=torch.maximum(buf.max_prio, landed.max()))


# --------------------------------------------------------------- plan (s,a)
def _mul32(x: torch.Tensor, c) -> torch.Tensor:
    """``x · c mod 2**32`` for x, c in [0, 2**32) (int64 tensors or an
    int): ``c`` split in 16-bit halves, so no partial product leaves
    int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def hash_state_action(s: torch.Tensor, a: torch.Tensor,
                      decimals: int = 3) -> torch.Tensor:
    """(B,) uint32 keys (held in int64) of 3-decimal-quantised states ⊕
    actions: the reference's multiply-xor of per-feature odd constants,
    the action folded in, then the murmur3 finalizer — bit for bit."""
    # round half to even, as jnp.round; a negative int32 wraps to uint32
    q = torch.round(s * (10.0 ** decimals)).to(torch.int32).to(
        torch.int64) & MASK32
    j = torch.arange(q.shape[-1], dtype=torch.int64, device=s.device)
    c = ((j * 2654435761 + 0x9E3779B1) & MASK32) | 1
    h = _mul32(q, c).sum(-1) & MASK32
    h = h ^ _mul32(a.to(torch.int64) & MASK32, 0x85EBCA6B)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def plan_init(capacity: int, state_dim: int, device="cuda") -> PlanRing:
    buf = prio_init(capacity, state_dim, device)
    return PlanRing(buf, torch.zeros((capacity + 1,), dtype=torch.int64,
                                     device=buf.prio.device))


def plan_contains(buf: PlanRing, h: torch.Tensor) -> torch.Tensor:
    """(B,) bool — is each key among the written slots' keys?  The
    written keys are sorted (unwritten slots as -1, below every key) and
    each query binary-searched: the reference's dense compare's
    booleans."""
    ring = buf.buf.ring
    cap = ring.capacity
    written = torch.arange(cap, device=h.device) < ring.size
    keys = torch.sort(torch.where(written, buf.keys[:cap], -1)).values
    pos = torch.searchsorted(keys, h).clamp(max=cap - 1)
    return keys[pos] == h


def plan_add(buf: PlanRing, h, s, a, r, s2, done, mask=None) -> PlanRing:
    """Write the masked-in (novel) rows and record their keys; the other
    rows are skipped, as Algorithm 1 lines 28-32 skip a known (s, a)."""
    ring = buf.buf.ring
    idx, n_new = _write_slots(ring.ptr, ring.capacity, a.shape[0], mask)
    buf.keys.index_copy_(0, idx, h)
    return PlanRing(_prio_put(buf.buf, idx, n_new, s, a, r, s2, done),
                    buf.keys)
