"""Cross-process clocks and stat accumulators — the port of
pytorch_distributed_tpu/agents/clocks.py (:20-168).

Every field is a ``multiprocessing`` object of the spawn context, so one
instance made by the topology is addressable from every worker, whether
the workers are child processes or threads of the learner's process.  The
learner step is the global clock that ends every loop; actors and the
learner push into their accumulators, and the logger drains and resets
them on its cadence.  The evaluator hands each result to the logger
through the ``EvaluatorStats`` flag handshake.

The clock also carries the hang watchdog's progress board
(utils/supervision.py ``ProgressBoard``), which the topology attaches
before any worker spawns, and the counters a checkpoint epoch records:
the skipped steps (brought up to date on the learner's stats cadence and
at every epoch) and the rollbacks (one per rollback of the learner's
health sentinel, agents/learner.py).
"""

from __future__ import annotations

import multiprocessing as mp

_CTX = mp.get_context("spawn")


class GlobalClock:
    """The global step counters, the best evaluation so far, and the
    run's stop event."""

    def __init__(self):
        self.actor_step = _CTX.Value("l", 0, lock=True)
        self.learner_step = _CTX.Value("l", 0, lock=True)
        # shared so no evaluator can overwrite ``<refs>_best`` with a
        # worse policy than the best one seen (agents/evaluator.py)
        self.best_eval_reward = _CTX.Value("d", float("-inf"), lock=True)
        # cooperative shutdown: set when the learner ends or a worker dies
        self.stop = _CTX.Event()
        # the counters an epoch's extras record
        self.skipped_steps = _CTX.Value("l", 0, lock=True)
        self.rollbacks = _CTX.Value("l", 0, lock=True)
        # the hang watchdog's board (utils/supervision.ProgressBoard),
        # attached by the topology before any spawn; its shared values
        # ride the clock's pickle into every child
        self.progress = None

    def bump_progress(self, label: str, n: int = 1) -> None:
        """A liveness mark for ``label`` (``actor-3``, ``learner``); a
        no-op when no board is attached."""
        if self.progress is not None:
            self.progress.bump(label, n)

    def add_skipped_steps(self, n: int) -> None:
        with self.skipped_steps.get_lock():
            self.skipped_steps.value += n

    def add_actor_steps(self, n: int = 1) -> int:
        with self.actor_step.get_lock():
            self.actor_step.value += n
            return self.actor_step.value

    def seed_actor_steps(self, n: int) -> None:
        """Additive restore of an epoch's actor-step count: actors may
        already be stepping when the learner restores, so the count is
        added under the lock, not written over their first steps."""
        with self.actor_step.get_lock():
            self.actor_step.value += n

    def set_learner_step(self, value: int) -> None:
        with self.learner_step.get_lock():
            self.learner_step.value = value

    def done(self, steps: int) -> bool:
        """The end of every worker loop."""
        return self.stop.is_set() or self.learner_step.value >= steps


class _Accumulator:
    """A drain-and-reset float accumulator group."""

    FIELDS: tuple = ()

    def __init__(self):
        self._lock = _CTX.Lock()
        for f in self.FIELDS:
            setattr(self, f, _CTX.Value("d", 0.0, lock=False))

    def add(self, **kv: float) -> None:
        with self._lock:
            for k, v in kv.items():
                getattr(self, k).value += v

    def drain(self) -> dict:
        """Read out and zero every field at once."""
        with self._lock:
            out = {f: getattr(self, f).value for f in self.FIELDS}
            for f in self.FIELDS:
                getattr(self, f).value = 0.0
            return out


class ActorStats(_Accumulator):
    """Rollout stats summed over all actors."""

    FIELDS = ("nepisodes", "nepisodes_solved", "total_steps",
              "total_reward", "total_nframes")


class LearnerStats(_Accumulator):
    """The learner's loss accumulators, one ``counter`` per add."""

    FIELDS = ("counter", "critic_loss", "actor_loss", "q_mean", "grad_norm",
              "steps_per_sec", "moe_aux")


class EvaluatorStats:
    """Evaluator -> logger handshake: the evaluator writes a result and
    raises the flag; the logger consumes it and lowers the flag.  ``done``
    is raised when the evaluator exits, after its final evaluation."""

    FIELDS = ("avg_steps", "avg_reward", "nepisodes", "nepisodes_solved")

    def __init__(self):
        self._lock = _CTX.Lock()
        self.flag = _CTX.Value("b", 0, lock=False)
        self.at_step = _CTX.Value("l", 0, lock=False)
        # the wall time the evaluated weights were captured at
        self.at_wall = _CTX.Value("d", 0.0, lock=False)
        self.done = _CTX.Value("b", 0, lock=False)
        for f in self.FIELDS:
            setattr(self, f, _CTX.Value("d", 0.0, lock=False))

    def publish(self, learner_step: int, wall: float = 0.0,
                **kv: float) -> None:
        with self._lock:
            for k, v in kv.items():
                getattr(self, k).value = v
            self.at_step.value = learner_step
            self.at_wall.value = wall
            self.flag.value = 1

    def consume(self):
        """``(learner_step, wall or 0, stats)``, or None if nothing new."""
        with self._lock:
            if not self.flag.value:
                return None
            out = {f: getattr(self, f).value for f in self.FIELDS}
            step, wall = self.at_step.value, self.at_wall.value
            self.flag.value = 0
            return step, wall, out
