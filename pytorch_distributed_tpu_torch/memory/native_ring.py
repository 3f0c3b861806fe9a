"""Lock-free shared replay ring in C++ — the port of
pytorch_distributed_tpu/memory/native_ring.py:1-141 (``memory_type=
"native"``).

The same six-column ring as ``SharedReplay``, held in one spawn-context
``mp.Array`` region that ``native/ring_buffer.cpp`` addresses: writers
claim rows with one atomic add on the cursor and each row carries a
seqlock word, so feeds never block one another and a sample retries a
torn row.  A row is one structured-dtype record, so a feed is one memcpy.
The source is read in place and built by ``utils/native_build.py`` into
``pytorch_distributed_tpu_torch/build/libring_buffer.so``; a build that
fails raises ``NativeBuildError`` with g++'s stderr, where the reference
warns and takes ``SharedReplay`` (factory.py:891-905).
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
from pytorch_distributed_tpu_torch.utils.native_build import load_library

_CTX = mp.get_context("spawn")
_LIB = None


def get_lib():
    """The ring's library, built on first use and bound once a process."""
    global _LIB
    if _LIB is None:
        lib = load_library("ring_buffer")
        u64, p = ctypes.c_uint64, ctypes.c_void_p
        lib.rb_region_bytes.argtypes = [u64, u64]
        lib.rb_region_bytes.restype = u64
        lib.rb_init.argtypes = [p, u64, u64]
        lib.rb_check.argtypes = [p, u64, u64]
        lib.rb_check.restype = ctypes.c_int
        lib.rb_total.argtypes = [p]
        lib.rb_total.restype = u64
        lib.rb_size.argtypes = [p]
        lib.rb_size.restype = u64
        lib.rb_feed.argtypes = [p, p, u64]
        lib.rb_sample.argtypes = [p, p, u64, p]
        lib.rb_sample.restype = u64
        _LIB = lib
    return _LIB


class NativeRingReplay(DirectFeed, Memory):
    def __init__(self, capacity: int, state_shape: Tuple[int, ...],
                 action_shape: Tuple[int, ...] = (),
                 state_dtype=np.uint8, action_dtype=np.int32):
        super().__init__(capacity, state_shape, action_shape,
                         state_dtype, action_dtype)
        lib = get_lib()
        self.row_dtype = np.dtype([
            ("state0", self.state_dtype, self.state_shape),
            ("action", self.action_dtype, self.action_shape),
            ("reward", np.float32),
            ("gamma_n", np.float32),
            ("state1", self.state_dtype, self.state_shape),
            ("terminal1", np.float32),
        ])
        nbytes = int(lib.rb_region_bytes(capacity, self.row_dtype.itemsize))
        self._region = _CTX.Array(ctypes.c_char, nbytes, lock=False)
        lib.rb_init(self._base(), capacity, self.row_dtype.itemsize)
        self.sample_retries = 0  # torn reads retried

    def _base(self) -> int:
        return ctypes.addressof(self._region)

    def __setstate__(self, d):
        # a spawn child attaches to the parent's pages: check the header,
        # never initialise it again
        self.__dict__.update(d)
        if not get_lib().rb_check(self._base(), self.capacity,
                                  self.row_dtype.itemsize):
            raise RuntimeError("the attached region does not hold a ring "
                               "of this geometry")

    @property
    def size(self) -> int:
        return int(get_lib().rb_size(self._base()))

    @property
    def total_feeds(self) -> int:
        return int(get_lib().rb_total(self._base()))

    def feed(self, transition: Transition,
             priority: Optional[float] = None) -> None:
        row = np.empty(1, dtype=self.row_dtype)
        for f in REPLAY_FIELDS:
            row[0][f] = getattr(transition, f)
        get_lib().rb_feed(self._base(), row.ctypes.data, 1)

    def feed_batch(self, ts: Transition) -> None:
        n = len(np.atleast_1d(ts.reward))
        rows = np.empty(n, dtype=self.row_dtype)
        for f in REPLAY_FIELDS:
            rows[f] = getattr(ts, f)
        get_lib().rb_feed(self._base(), rows.ctypes.data, n)

    def sample(self, batch_size: int, rng: np.random.Generator) -> Batch:
        size = self.size
        if size <= 0:
            raise RuntimeError("sampling from an empty replay")
        idx = rng.integers(0, size, size=batch_size).astype(np.uint64)
        out = np.empty(batch_size, dtype=self.row_dtype)
        self.sample_retries += int(get_lib().rb_sample(
            self._base(), idx.ctypes.data, batch_size, out.ctypes.data))
        return Batch(**{f: np.ascontiguousarray(out[f])
                        for f in REPLAY_FIELDS},
                     weight=np.ones(batch_size, dtype=np.float32),
                     index=idx.astype(np.int32))
