"""Experience replay: uniform ring buffer (DQN) and proportional
prioritized replay with a sum-tree (APEX_DQN, Horgan et al. 2018)."""
from __future__ import annotations

import numpy as np


class ReplayBuffer:
    def __init__(self, capacity: int, state_dim: int, n_step_meta: bool = False):
        self.capacity = capacity
        self.s = np.zeros((capacity, state_dim), np.float32)
        self.a = np.zeros((capacity,), np.int32)
        self.r = np.zeros((capacity,), np.float32)
        self.s2 = np.zeros((capacity, state_dim), np.float32)
        self.done = np.zeros((capacity,), np.float32)
        self.mask2 = None  # legal-action mask of s2, set lazily
        self.discount = np.ones((capacity,), np.float32)
        # reward-quality mark from the measurement guardrails: a transition
        # whose reward came from a still-noisy measurement never sits in
        # the buffer unmarked — learners read ``noisy[idx]`` (sample()
        # returns idx) and down-weight
        self.noisy = np.zeros((capacity,), bool)
        self.size = 0
        self.pos = 0

    def _ensure_mask(self, n_actions: int):
        if self.mask2 is None:
            self.mask2 = np.ones((self.capacity, n_actions), bool)

    def add(self, s, a, r, s2, done, mask2=None, discount: float = 1.0,
            noisy: bool = False) -> int:
        i = self.pos
        self.s[i] = s
        self.a[i] = a
        self.r[i] = r
        self.s2[i] = s2
        self.done[i] = float(done)
        self.discount[i] = discount
        self.noisy[i] = bool(noisy)
        if mask2 is not None:
            self._ensure_mask(len(mask2))
            self.mask2[i] = mask2
        self.pos = (self.pos + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)
        return i

    def sample(self, batch: int, rng: np.random.Generator):
        idx = rng.integers(0, self.size, size=batch)
        return self[idx]

    def __getitem__(self, idx):
        mask2 = self.mask2[idx] if self.mask2 is not None else None
        return (
            self.s[idx],
            self.a[idx],
            self.r[idx],
            self.s2[idx],
            self.done[idx],
            mask2,
            self.discount[idx],
            idx,
        )


class SumTree:
    """Array-backed binary sum-tree for O(log n) proportional sampling."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.tree = np.zeros(2 * capacity, np.float64)

    def set(self, idx: int, value: float) -> None:
        i = idx + self.capacity
        delta = value - self.tree[i]
        while i >= 1:
            self.tree[i] += delta
            i //= 2

    def total(self) -> float:
        return self.tree[1]

    def get(self, idx: int) -> float:
        return self.tree[idx + self.capacity]

    def sample(self, u: float) -> int:
        """Find leaf with prefix-sum >= u."""
        i = 1
        while i < self.capacity:
            left = self.tree[2 * i]
            if u <= left:
                i = 2 * i
            else:
                u -= left
                i = 2 * i + 1
        return i - self.capacity


class PrioritizedReplay(ReplayBuffer):
    def __init__(
        self,
        capacity: int,
        state_dim: int,
        alpha: float = 0.6,
        beta0: float = 0.4,
        beta_steps: int = 10_000,
        eps: float = 1e-3,
    ):
        super().__init__(capacity, state_dim)
        self.tree = SumTree(capacity)
        self.alpha = alpha
        self.beta0 = beta0
        self.beta_steps = beta_steps
        self.eps = eps
        self.max_priority = 1.0
        self.samples_drawn = 0

    def add(self, s, a, r, s2, done, mask2=None, discount: float = 1.0,
            noisy: bool = False) -> int:
        i = super().add(s, a, r, s2, done, mask2, discount, noisy)
        self.tree.set(i, self.max_priority**self.alpha)
        return i

    def beta(self) -> float:
        frac = min(1.0, self.samples_drawn / self.beta_steps)
        return self.beta0 + (1.0 - self.beta0) * frac

    def sample(self, batch: int, rng: np.random.Generator):
        total = self.tree.total()
        us = rng.uniform(0.0, total, size=batch)
        idx = np.array([self.tree.sample(u) for u in us], np.int64)
        idx = np.clip(idx, 0, self.size - 1)
        probs = np.array([self.tree.get(i) for i in idx]) / max(total, 1e-12)
        weights = (self.size * np.maximum(probs, 1e-12)) ** (-self.beta())
        weights /= weights.max() + 1e-12
        self.samples_drawn += batch
        data = self[idx]
        return data, weights.astype(np.float32)

    def update_priorities(self, idx, td_errors) -> None:
        prios = np.abs(td_errors) + self.eps
        self.max_priority = max(self.max_priority, float(prios.max()))
        for i, p in zip(idx, prios):
            self.tree.set(int(i), float(p) ** self.alpha)
