"""Run clocks and stat accumulators — the port of
pytorch_distributed_tpu/agents/clocks.py in thread-backend form (threading
primitives instead of spawn-context shared values).

The learner step is the global clock that ends every loop; actors count
env steps for the replay-ratio pacing.
"""

from __future__ import annotations

import threading


class GlobalClock:
    def __init__(self):
        self._lock = threading.Lock()
        self.actor_step = 0
        self.learner_step = 0
        self.stop = threading.Event()

    def add_actor_steps(self, n: int = 1) -> int:
        with self._lock:
            self.actor_step += n
            return self.actor_step

    def set_learner_step(self, value: int) -> None:
        with self._lock:
            self.learner_step = value

    def done(self, steps: int) -> bool:
        return self.stop.is_set() or self.learner_step >= steps


class ActorStats:
    """Episode stats summed over all actor threads."""

    FIELDS = ("nepisodes", "total_reward", "total_nframes")

    def __init__(self):
        self._lock = threading.Lock()
        self._acc = dict.fromkeys(self.FIELDS, 0.0)

    def add(self, **kv: float) -> None:
        with self._lock:
            for k, v in kv.items():
                self._acc[k] += float(v)

    def read(self) -> dict:
        with self._lock:
            return dict(self._acc)
