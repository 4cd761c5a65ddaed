"""Replay buffers of Algorithm 1 for the single-cell agents: D_direct
(prioritized), D_world (uniform) and D_plan (prioritized, with (s, a)
membership).

Counterpart of ``repro.core.replay``: numpy rings on the host, drawing
from their own ``np.random.default_rng(seed)`` in the reference's order
(``integers`` for uniform draws, ``choice(n, p=p)`` over float64
priorities), so the same adds and seeds sample the same rows and
weights bit for bit.  Prioritized sampling follows Schaul et al.:
P(i) ∝ p_i^α, importance weights (N·P(i))^−β normalized by their max.
The fleet trainer's device rings are ``repro_torch.hltrain.buffers``.
"""
from __future__ import annotations

import numpy as np


class ReplayBuffer:
    """Uniform ring buffer of (s, a, r, s', done)."""

    def __init__(self, capacity: int, state_dim: int, seed: int = 0):
        self.capacity = capacity
        self.n = 0
        self.ptr = 0
        self.s = np.zeros((capacity, state_dim), np.float32)
        self.a = np.zeros((capacity,), np.int32)
        self.r = np.zeros((capacity,), np.float32)
        self.s2 = np.zeros((capacity, state_dim), np.float32)
        self.done = np.zeros((capacity,), np.float32)
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.n

    def add(self, s, a, r, s2, done) -> int:
        i = self.ptr
        self.s[i], self.a[i], self.r[i] = s, a, r
        self.s2[i], self.done[i] = s2, float(done)
        self.ptr = (self.ptr + 1) % self.capacity
        self.n = min(self.n + 1, self.capacity)
        return i

    def sample(self, batch: int):
        idx = self.rng.integers(0, self.n, size=batch)
        return self._gather(idx), idx, np.ones(batch, np.float32)

    def _gather(self, idx):
        return (self.s[idx], self.a[idx], self.r[idx], self.s2[idx],
                self.done[idx])


class PrioritizedReplayBuffer(ReplayBuffer):
    def __init__(self, capacity: int, state_dim: int, *, alpha: float = 0.6,
                 beta: float = 0.4, seed: int = 0):
        super().__init__(capacity, state_dim, seed)
        self.alpha = alpha
        self.beta = beta
        self.prio = np.zeros((capacity,), np.float64)
        self.max_prio = 1.0

    def add(self, s, a, r, s2, done) -> int:
        i = super().add(s, a, r, s2, done)
        self.prio[i] = self.max_prio  # new samples get max priority
        return i

    def sample(self, batch: int):
        p = self.prio[:self.n] ** self.alpha
        p = p / p.sum()
        idx = self.rng.choice(self.n, size=batch, p=p)
        w = (self.n * p[idx]) ** (-self.beta)
        w = (w / w.max()).astype(np.float32)
        return self._gather(idx), idx, w

    def update_priorities(self, idx, td_errors):
        pr = np.abs(np.asarray(td_errors)) + 1e-4
        self.prio[idx] = pr
        self.max_prio = max(self.max_prio, float(pr.max()))


class PlanBuffer(PrioritizedReplayBuffer):
    """D_plan: a prioritized buffer with (state-key, action) membership.

    Algorithm 1 lines 28–32: a suggested action runs in the real
    environment only if (s, a) is not present yet; otherwise its stored
    entry is refreshed.  A ring overwrite evicts the overwritten row's
    key."""

    def __init__(self, capacity: int, state_dim: int, **kw):
        super().__init__(capacity, state_dim, **kw)
        self._index: dict[tuple, int] = {}
        self._keys: list = [None] * capacity

    def contains(self, key, action) -> bool:
        return (key, int(action)) in self._index

    def add_keyed(self, key, s, a, r, s2, done) -> int:
        k = (key, int(a))
        if k in self._index:  # refresh in place (line 32)
            i = self._index[k]
            self.s[i], self.r[i] = s, r
            self.s2[i], self.done[i] = s2, float(done)
            self.prio[i] = self.max_prio
            return i
        i = self.add(s, a, r, s2, done)
        old = self._keys[i]
        if old is not None and old in self._index and self._index[old] == i:
            del self._index[old]  # ring overwrite
        self._keys[i] = k
        self._index[k] = i
        return i
