"""Per-phase wall-time accounting — the port's copy of ``StepTimer`` from
pytorch_distributed_tpu/utils/profiling.py (:33-100).  The trace window
around the profiler is not ported yet.

A worker wraps its hot loop's phases (the actors: ``act``, ``dispatch``,
``sync``, ``env``, ``advance``, ``param_swap``) and drains the timer on its
stats cadence into ``scalars.jsonl``, under the reference's tags:
``{prefix}/time_{phase}_ms`` (the window's mean), ``_max_ms``, ``_calls``,
``_total_ms`` and ``_last_wall`` (the wall clock of the phase's last
occurrence).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator


class StepTimer:
    """Wall seconds per named phase; ``drain()`` returns the window's
    per-phase mean, max, count and total, and resets.  The max rides along
    because a mean averages one long stall away."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self._acc: Dict[str, float] = {}
        self._max: Dict[str, float] = {}
        self._n: Dict[str, int] = {}
        self._last_wall: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        """Book a duration timed by the caller (the pipelined actor books
        its dispatch and sync each under their own phase and, summed,
        under ``act``, so the two schedules read alike)."""
        self._acc[name] = self._acc.get(name, 0.0) + seconds
        if seconds > self._max.get(name, 0.0):
            self._max[name] = seconds
        self._n[name] = self._n.get(name, 0) + 1
        self._last_wall[name] = time.time()

    def drain(self) -> Dict[str, float]:
        out = {}
        for name, secs in self._acc.items():
            n = self._n[name]
            out[f"{self.prefix}/time_{name}_ms"] = secs / max(n, 1) * 1e3
            out[f"{self.prefix}/time_{name}_max_ms"] = \
                self._max.get(name, 0.0) * 1e3
            out[f"{self.prefix}/time_{name}_calls"] = float(n)
            out[f"{self.prefix}/time_{name}_total_ms"] = secs * 1e3
            out[f"{self.prefix}/time_{name}_last_wall"] = \
                self._last_wall.get(name, 0.0)
        self._acc.clear()
        self._max.clear()
        self._n.clear()
        self._last_wall.clear()
        return out
