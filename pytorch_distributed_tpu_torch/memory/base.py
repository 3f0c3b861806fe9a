"""Replay-memory interface — the port's copy of
pytorch_distributed_tpu/memory/base.py:18-42 (shapes, capacity, the
circular ``size``, ``feed``, ``sample``, ``update_priorities``), and the
topology's surface of a ring the actors write in place (``DirectFeed``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from pytorch_distributed_tpu_torch.utils.experience import Batch, Transition


class Memory:
    # whether the ring samples in proportion to priorities the learner
    # writes back (``update_priorities``)
    prioritized = False

    def __init__(self, capacity: int, state_shape: Tuple[int, ...],
                 action_shape: Tuple[int, ...] = (),
                 state_dtype=np.uint8, action_dtype=np.int32):
        self.capacity = capacity
        self.state_shape = tuple(state_shape)
        self.action_shape = tuple(action_shape)
        self.state_dtype = np.dtype(state_dtype)
        self.action_dtype = np.dtype(action_dtype)

    @property
    def size(self) -> int:
        raise NotImplementedError

    def feed(self, transition: Transition,
             priority: Optional[float] = None) -> None:
        raise NotImplementedError

    def sample(self, batch_size: int, rng: np.random.Generator) -> Batch:
        raise NotImplementedError

    def update_priorities(self, indices: np.ndarray,
                          priorities: np.ndarray) -> None:
        """No-op for uniform replay."""

    def xray(self) -> Optional[dict]:
        """The priority X-ray the health plane reads each stats window
        (``rows``, ``mass``, ``ess``, ``ess_frac``); None for uniform
        replay."""
        return None


class DirectFeeder:
    """An actor's feed endpoint on a ring in process-shared pages: each
    ``feed`` writes the row in place, as the reference's actors write
    ``SharedReplay`` (reference core/memories/shared_memory.py:45-57).
    Pickles with its ring across a spawn."""

    def __init__(self, memory: Memory):
        self.memory = memory

    def feed(self, transition: Transition) -> None:
        self.memory.feed(transition)

    def flush(self) -> None:
        pass

    def set_stop(self, event) -> None:
        pass

    def close(self) -> None:
        pass


class DirectFeed:
    """The topology's surface (runtime.py) of a ring that every actor
    writes in place: each slot's feeder is a ``DirectFeeder`` on the ring
    itself, there is no queue to bind, close or drain, and no ingest
    boundary to validate at."""

    validated = quarantined = 0
    validate_s = 0.0

    def make_feeder(self, slot: int = 0, chunk: int = 16) -> DirectFeeder:
        return DirectFeeder(self)

    def replace_slot(self, slot: int, chunk: int = 16) -> DirectFeeder:
        return DirectFeeder(self)

    def bind_producer(self, slot: int, sentinel) -> None:
        pass

    def close_write_end(self, slot: int) -> None:
        pass

    def drain(self, max_chunks: int = 1024) -> int:
        return 0

    def close(self) -> None:
        pass
