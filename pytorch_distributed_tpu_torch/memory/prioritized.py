"""Proportional prioritized replay on the host — the port's copy of
pytorch_distributed_tpu/memory/prioritized.py:34-207, without the
bandwidth plane's occupancy gauge (``bandwidth.note_host_replay``, ROADMAP.md
Queue A item 5) and the provenance sidecar.

A single-owner ring (the learner's process; actors reach it through
memory/feeder.py ``QueueOwner``): proportional sampling through the
``SumTree``, new rows at the running max priority, importance weights
normalised by the largest weight (``MinTree``) with beta annealed by the
number of draws, |TD| written back after each update.  Priorities are
stored as ``(|td| + eps) ** alpha``; ``max_priority`` is kept in the
unexponentiated unit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from pytorch_distributed_tpu_torch.memory.base import Memory
from pytorch_distributed_tpu_torch.utils import health
from pytorch_distributed_tpu_torch.utils.experience import (
    REPLAY_FIELDS, Batch, Transition,
)
from pytorch_distributed_tpu_torch.utils.segment_tree import MinTree, SumTree


class PrioritizedReplay(Memory):
    prioritized = True

    def __init__(self, capacity: int, state_shape: Tuple[int, ...],
                 action_shape: Tuple[int, ...] = (),
                 state_dtype=np.uint8, action_dtype=np.int32,
                 priority_exponent: float = 0.6,
                 importance_weight: float = 0.4,
                 importance_anneal_steps: int = 500000,
                 epsilon: float = 1e-6):
        super().__init__(capacity, state_shape, action_shape,
                         state_dtype, action_dtype)
        N = capacity
        self.state0 = np.zeros((N, *self.state_shape), dtype=self.state_dtype)
        self.action = np.zeros((N, *self.action_shape),
                               dtype=self.action_dtype)
        self.reward = np.zeros((N,), dtype=np.float32)
        self.gamma_n = np.zeros((N,), dtype=np.float32)
        self.state1 = np.zeros((N, *self.state_shape), dtype=self.state_dtype)
        self.terminal1 = np.zeros((N,), dtype=np.float32)
        self.sum_tree = SumTree(N)
        self.min_tree = MinTree(N)
        self.alpha = priority_exponent
        self.beta0 = importance_weight
        self.beta_steps = importance_anneal_steps
        self.eps = epsilon
        self.max_priority = 1.0
        self._pos = 0
        self._full = False
        self._samples_drawn = 0

    @property
    def size(self) -> int:
        return self.capacity if self._full else self._pos

    @property
    def beta(self) -> float:
        frac = min(1.0, self._samples_drawn / max(1, self.beta_steps))
        return self.beta0 + (1.0 - self.beta0) * frac

    def _priority(self, p: Optional[float]) -> float:
        # a new row enters at the running max, so every row is replayed
        # at least once
        base = self.max_priority if p is None else abs(float(p)) + self.eps
        return base ** self.alpha

    def feed(self, transition: Transition,
             priority: Optional[float] = None) -> None:
        i = self._pos
        for f in REPLAY_FIELDS:
            getattr(self, f)[i] = getattr(transition, f)
        pr = self._priority(priority)
        self.sum_tree.set(i, pr)
        self.min_tree.set(i, pr)
        self.max_priority = max(self.max_priority,
                                pr ** (1.0 / self.alpha) if self.alpha else pr)
        self._pos = (i + 1) % self.capacity
        self._full = self._full or self._pos == 0

    def sample(self, batch_size: int, rng: np.random.Generator) -> Batch:
        if self.size <= 0:
            raise RuntimeError("sampling from an empty replay")
        idx = self.sum_tree.sample(batch_size, rng)
        self._samples_drawn += 1
        probs = self.sum_tree.get(idx) / self.sum_tree.total
        beta = self.beta
        weights = (self.size * probs) ** (-beta)
        min_prob = self.min_tree.min / self.sum_tree.total
        max_weight = (self.size * min_prob) ** (-beta)
        weights = (weights / max_weight).astype(np.float32)
        return Batch(**{f: getattr(self, f)[idx].copy()
                        for f in REPLAY_FIELDS},
                     weight=weights, index=idx.astype(np.int32))

    def snapshot(self) -> dict:
        """The valid rows, oldest first, with their leaf priorities
        (``p ** alpha``, restored as they are), the running max in the
        unexponentiated unit, the draw count and the exponent."""
        n = self.size
        shift = -self._pos if self._full else 0
        out = {f: np.roll(getattr(self, f), shift, axis=0)[:n].copy()
               for f in REPLAY_FIELDS}
        out["leaf_priority"] = np.roll(
            self.sum_tree.get(np.arange(self.capacity)), shift)[:n].copy()
        out["max_priority_base"] = np.float64(self.max_priority)
        out["samples_drawn"] = np.int64(self._samples_drawn)
        out["alpha"] = np.float64(self.alpha)
        return out

    def restore(self, data: dict) -> int:
        """Refill from a snapshot, keeping the newest rows that fit;
        leaves saved under another exponent are re-exponentiated, and a
        snapshot without leaves (a uniform ring's) enters at the max.
        Returns the rows restored."""
        n = min(len(np.asarray(data["reward"])), self.capacity)
        for f in REPLAY_FIELDS:
            getattr(self, f)[:n] = np.asarray(data[f])[-n:]
        if "leaf_priority" in data:
            leaves = np.asarray(data["leaf_priority"], dtype=np.float64)[-n:]
            saved_alpha = float(data.get("alpha", self.alpha))
            if saved_alpha != self.alpha and saved_alpha > 0:
                leaves = leaves ** (self.alpha / saved_alpha)
        else:
            leaves = np.full(n, self._priority(None), dtype=np.float64)
        idx = np.arange(n)
        self.sum_tree.set(idx, leaves)
        self.min_tree.set(idx, leaves)
        if n < self.capacity:
            # stale leaves past the restored rows: zero mass, and the min
            # tree's neutral +inf
            stale = np.arange(n, self.capacity)
            self.sum_tree.set(stale, np.zeros(len(stale)))
            self.min_tree.set(stale, np.full(len(stale), np.inf))
        self._pos = n % self.capacity
        self._full = n == self.capacity
        self.max_priority = float(data.get("max_priority_base", 1.0))
        self._samples_drawn = int(data.get("samples_drawn", 0))
        return n

    def priority_leaves(self) -> np.ndarray:
        """The valid rows' leaves (``p ** alpha``): the X-ray's input."""
        return self.sum_tree.get(np.arange(self.size))

    def xray(self) -> dict:
        return health.priority_xray(self.priority_leaves()) or {
            "rows": 0, "mass": 0.0, "ess": 0.0, "ess_frac": None}

    def update_priorities(self, indices: np.ndarray,
                          priorities: np.ndarray) -> None:
        priorities = np.abs(np.asarray(priorities, dtype=np.float64)) \
            + self.eps
        pr = priorities ** self.alpha
        self.sum_tree.set(indices, pr)
        self.min_tree.set(indices, pr)
        self.max_priority = max(self.max_priority, float(priorities.max()))
