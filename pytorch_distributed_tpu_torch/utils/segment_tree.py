"""Segment trees for the host PER ring — the port's copy of
pytorch_distributed_tpu/utils/segment_tree.py (numpy, no framework).

``SumTree``: a flat-array binary sum tree over ``capacity`` leaf
priorities with vectorised batch set, prefix-sum descent and stratified
sampling; ``MinTree``: the minimum priority, for the largest
importance-sampling weight of PER (memory/prioritized.py).
"""

from __future__ import annotations

import numpy as np


class SumTree:
    """Fixed-capacity binary sum tree over ``capacity`` leaf priorities.

    Layout: ``tree[1]`` is the root; leaves occupy
    ``tree[capacity : 2*capacity]`` (capacity rounded up to a power of two),
    so parent/child index math is pure bit shifts and batch updates
    vectorize.
    """

    def __init__(self, capacity: int):
        assert capacity > 0
        self.capacity = capacity
        self._size = 1
        while self._size < capacity:
            self._size *= 2
        self.tree = np.zeros(2 * self._size, dtype=np.float64)

    # -- updates ------------------------------------------------------------

    def set(self, indices: np.ndarray, priorities: np.ndarray) -> None:
        """Set leaf priorities at ``indices`` (vectorized, duplicates allowed
        — last write wins per numpy fancy-assignment semantics, then the
        whole affected path set is re-aggregated)."""
        indices = np.asarray(indices, dtype=np.int64)
        priorities = np.asarray(priorities, dtype=np.float64)
        if indices.ndim == 0:
            indices = indices[None]
            priorities = priorities[None]
        if indices.size == 0:
            return
        assert np.all((indices >= 0) & (indices < self.capacity))
        assert np.all(priorities >= 0)
        nodes = indices + self._size
        self.tree[nodes] = priorities
        # Walk all touched paths up level by level, recomputing from children
        # (duplicate-safe: recompute instead of add-delta).
        nodes = np.unique(nodes) >> 1
        while nodes[0] >= 1:
            self.tree[nodes] = self.tree[2 * nodes] + self.tree[2 * nodes + 1]
            nodes = np.unique(nodes >> 1)
            if nodes[-1] < 1:
                break

    # -- queries ------------------------------------------------------------

    @property
    def total(self) -> float:
        """The sum of every leaf (the root)."""
        return float(self.tree[1])

    def get(self, indices: np.ndarray) -> np.ndarray:
        indices = np.asarray(indices, dtype=np.int64)
        return self.tree[indices + self._size]

    def find(self, values: np.ndarray) -> np.ndarray:
        """Batch prefix-sum descent: for each ``v in [0, total)`` return the
        leaf index i such that cumsum(priorities)[i-1] <= v <
        cumsum(priorities)[i], for all values at once, level by level."""
        values = np.asarray(values, dtype=np.float64).copy()
        if values.ndim == 0:
            values = values[None]
        if values.size == 0:
            return values.astype(np.int64)
        nodes = np.ones_like(values, dtype=np.int64)
        while nodes[0] < self._size:  # all nodes are on the same level
            left = 2 * nodes
            left_sum = self.tree[left]
            go_right = values >= left_sum
            values = np.where(go_right, values - left_sum, values)
            nodes = np.where(go_right, left + 1, left)
        leaf = nodes - self._size
        # Guard the v == total edge and zero-priority tail slots.
        return np.minimum(leaf, self.capacity - 1)

    def sample(self, batch_size: int, rng: np.random.Generator,
               stratified: bool = True) -> np.ndarray:
        """Draw ``batch_size`` leaf indices with probability proportional to
        priority.  Stratified sampling (one uniform draw per equal-mass
        stratum) matches the Ape-X/Rainbow samplers and lowers variance."""
        total = self.total
        assert total > 0, "cannot sample from an empty sum tree"
        if stratified:
            bounds = np.linspace(0.0, total, batch_size + 1)
            values = rng.uniform(bounds[:-1], bounds[1:])
        else:
            values = rng.uniform(0.0, total, size=batch_size)
        return self.find(values)


class MinTree:
    """Fixed-capacity min tree — tracks the minimum priority for the max
    importance-sampling weight normalisation in PER."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._size = 1
        while self._size < capacity:
            self._size *= 2
        self.tree = np.full(2 * self._size, np.inf, dtype=np.float64)

    def set(self, indices: np.ndarray, priorities: np.ndarray) -> None:
        indices = np.asarray(indices, dtype=np.int64)
        priorities = np.asarray(priorities, dtype=np.float64)
        if indices.ndim == 0:
            indices = indices[None]
            priorities = priorities[None]
        if indices.size == 0:
            return
        assert np.all((indices >= 0) & (indices < self.capacity))
        nodes = indices + self._size
        self.tree[nodes] = priorities
        nodes = np.unique(nodes) >> 1
        while nodes[0] >= 1:
            self.tree[nodes] = np.minimum(self.tree[2 * nodes],
                                          self.tree[2 * nodes + 1])
            nodes = np.unique(nodes >> 1)
            if nodes[-1] < 1:
                break

    @property
    def min(self) -> float:
        return float(self.tree[1])
