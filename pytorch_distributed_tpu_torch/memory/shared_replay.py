"""Process-shared replay ring with uniform sampling — the port's copy of
pytorch_distributed_tpu/memory/shared_replay.py:41-198, with its
provenance sidecar (``prov``, an (N, 4) int64 column in the shared pages,
-1 = unknown; ``provenance_of``; :66-78, :132, :165-171, :195-198).

Six preallocated arrays of ``capacity`` rows (state0/state1 uint8 for
frames or float32 for low-dim states, action, reward, gamma_n, terminal1)
in spawn-context ``multiprocessing.Array`` pages wrapped as numpy views,
which survive pickling across a spawn; the write cursor and the full flag
are ``mp.Value``s and one ``mp.Lock`` serialises every feed and sample.
Every actor writes it in place (``DirectFeed``); the learner samples it
with its own numpy generator.
"""

from __future__ import annotations

import ctypes
import multiprocessing as mp
from typing import Optional, Tuple

import numpy as np

from pytorch_distributed_tpu_torch.memory.base import DirectFeed, Memory
from pytorch_distributed_tpu_torch.utils.experience import (
    REPLAY_FIELDS, Batch, Transition,
)

_CTYPES = {
    np.dtype(np.uint8): ctypes.c_uint8,
    np.dtype(np.float32): ctypes.c_float,
    np.dtype(np.int32): ctypes.c_int32,
    np.dtype(np.int64): ctypes.c_int64,
}

_CTX = mp.get_context("spawn")


def _shared_array(shape: Tuple[int, ...], dtype):
    n = int(np.prod(shape)) if shape else 1
    return _CTX.Array(_CTYPES[np.dtype(dtype)], n, lock=False)


class SharedReplay(DirectFeed, Memory):
    def __init__(self, capacity: int, state_shape: Tuple[int, ...],
                 action_shape: Tuple[int, ...] = (),
                 state_dtype=np.uint8, action_dtype=np.int32):
        super().__init__(capacity, state_shape, action_shape,
                         state_dtype, action_dtype)
        self._raw = {f: _shared_array(shape, dt)
                     for f, (shape, dt) in self._columns().items()}
        self._pos = _CTX.Value("l", 0, lock=False)
        self._full = _CTX.Value("b", 0, lock=False)
        self._count = _CTX.Value("l", 0, lock=False)   # total feeds
        self._lock = _CTX.Lock()
        self._bind_views()
        # shared pages come zeroed and (0, 0, 0, 0) is a valid vector:
        # unwritten rows read -1.  Here only: spawn children share the
        # pages and never wipe them
        self._np_prov[:] = -1

    def _columns(self) -> dict:
        N = self.capacity
        return dict(
            state0=((N, *self.state_shape), self.state_dtype),
            action=((N, *self.action_shape), self.action_dtype),
            reward=((N,), np.float32), gamma_n=((N,), np.float32),
            state1=((N, *self.state_shape), self.state_dtype),
            terminal1=((N,), np.float32),
            # the provenance sidecar, -1 rows = unknown
            prov=((N, 4), np.int64))

    # -- pickling across spawn ---------------------------------------------

    def __getstate__(self):
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_np_")}

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._bind_views()

    def _bind_views(self) -> None:
        for f, (shape, dt) in self._columns().items():
            setattr(self, f"_np_{f}",
                    np.frombuffer(self._raw[f], dtype=dt).reshape(shape))

    # -- Memory interface ---------------------------------------------------

    @property
    def size(self) -> int:
        return self.capacity if self._full.value else self._pos.value

    @property
    def total_feeds(self) -> int:
        return self._count.value

    def feed(self, transition: Transition,
             priority: Optional[float] = None) -> None:
        """One row at the cursor, circular; ``priority`` is taken for the
        interface and ignored (uniform replay)."""
        with self._lock:
            i = self._pos.value
            for f in REPLAY_FIELDS:
                getattr(self, f"_np_{f}")[i] = getattr(transition, f)
            self._np_prov[i] = (-1 if getattr(transition, "prov", None)
                                is None else transition.prov)
            nxt = i + 1
            if nxt >= self.capacity:
                self._full.value = 1
                nxt = 0
            self._pos.value = nxt
            self._count.value += 1

    def snapshot(self) -> dict:
        """The valid rows, oldest first, taken under the lock; ``count``
        is the total of feeds."""
        with self._lock:
            n = self.size
            shift = -self._pos.value if self._full.value else 0
            out = {f: np.roll(getattr(self, f"_np_{f}"), shift, axis=0)[:n]
                   .copy() for f in self._raw}
            out["count"] = np.int64(self._count.value)
            return out

    def restore(self, data: dict) -> int:
        """Refill from a snapshot, keeping the newest rows that fit; a
        snapshot without ``prov`` (one from before the column) restores -1
        rows.  Returns the rows restored."""
        with self._lock:
            n = min(len(np.asarray(data["reward"])), self.capacity)
            for f in REPLAY_FIELDS:
                getattr(self, f"_np_{f}")[:n] = np.asarray(data[f])[-n:]
            self._np_prov[:n] = (np.asarray(data["prov"], np.int64)[-n:]
                                 if "prov" in data else -1)
            # rows past the restored ones are dead until rewritten
            self._np_prov[n:] = -1
            self._pos.value = n % self.capacity
            self._full.value = int(n == self.capacity)
            self._count.value = int(data.get("count", n))
            return n

    def sample(self, batch_size: int, rng: np.random.Generator) -> Batch:
        """Uniform rows (copies, so the batch holds while actors write),
        IS weights 1."""
        with self._lock:
            size = self.size
            if size <= 0:
                raise RuntimeError("sampling from an empty replay")
            idx = rng.integers(0, size, size=batch_size)
            return Batch(**{f: getattr(self, f"_np_{f}")[idx].copy()
                            for f in REPLAY_FIELDS},
                         weight=np.ones(batch_size, dtype=np.float32),
                         index=idx.astype(np.int32))

    def provenance_of(self, indices: np.ndarray) -> np.ndarray:
        """(B, 4) int64 provenance of the given rows; -1 rows are
        unknown."""
        return self._np_prov[np.asarray(indices)].copy()
