"""Versioned parameter publication — the port of
pytorch_distributed_tpu/agents/param_store.py in thread-backend form.

The learner publishes a cloned snapshot of its parameter tensors (on its
device) with a version number; actors fetch the newest snapshot on their
sync cadence and swap it in.  A snapshot is never written after it is
published, so a fetched reference stays coherent.  On a GPU, ``publish``
waits until the clone has been made, so an actor may read the snapshot
from its own CUDA stream.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

import torch

Snapshot = Dict[str, torch.Tensor]


class ParamStore:
    def __init__(self):
        self._lock = threading.Lock()
        self._snap: Optional[Snapshot] = None
        self._version = 0

    @property
    def version(self) -> int:
        return self._version

    def publish(self, params: Snapshot) -> int:
        snap = {k: v.detach().clone() for k, v in params.items()}
        if any(v.is_cuda for v in snap.values()):
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        with self._lock:
            self._snap = snap
            self._version += 1
            return self._version

    def fetch(self, min_version: int = 0) -> Optional[Tuple[Snapshot, int]]:
        """``(snapshot, version)`` if newer than ``min_version``, else None."""
        with self._lock:
            if self._version <= min_version:
                return None
            return self._snap, self._version

    def wait(self, min_version: int = 0, timeout: float = 300.0,
             poll: float = 0.02, stop=None) -> Tuple[Snapshot, int]:
        """Block until a snapshot newer than ``min_version`` exists."""
        deadline = time.monotonic() + timeout
        while True:
            got = self.fetch(min_version)
            if got is not None:
                return got
            if stop is not None and stop.is_set():
                raise RuntimeError("stopped while waiting for params")
            if time.monotonic() > deadline:
                raise TimeoutError(f"no params published within {timeout}s")
            time.sleep(poll)
