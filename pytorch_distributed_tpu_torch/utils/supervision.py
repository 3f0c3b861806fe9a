"""Crash-loop restart policy and the hang watchdog's progress board — the
port's own copy of pytorch_distributed_tpu/utils/supervision.py (:1-166),
which it may not import.

Per slot: a restart is granted while fewer than ``max_restarts``
incarnations have crashed *young*; an incarnation that lived longer than
``grace`` seconds proves the previous crash was isolated and resets the
slot's budget, so only genuine crash loops exhaust it.  The runtime's
monitor (runtime.py ``Topology._monitor``) and the fleet's actor host
(fleet.py ``run_fleet_actors``, with ``backoff``) are its callers.
"""

from __future__ import annotations

import multiprocessing as mp
import time
from typing import Dict, Iterable, List, Optional

_CTX = mp.get_context("spawn")

# Worker exit-code vocabulary, the reference's codes and strings, so logs
# of either package read alike.  EXIT_DISCONNECTED is a remote actor's
# exit on a terminal DCN session loss (fleet.py ``_remote_actor_main``),
# which its actor host's RestartBudget respawns.  EXIT_HUNG marks a
# worker the hang watchdog SIGKILLed for making no progress within its
# deadline (alive-but-stuck: the failure mode that never produces an exit
# code on its own).
EXIT_OK = 0
EXIT_CRASH = 1
EXIT_DISCONNECTED = 3
EXIT_HUNG = 4


def describe_exit(code: Optional[int]) -> str:
    """Human-readable worker exit for supervisor logs."""
    if code == EXIT_OK:
        return "exit 0 (run complete)"
    if code == EXIT_DISCONNECTED:
        return f"exit {code} (DCN session lost)"
    if code == EXIT_HUNG:
        return f"exit {code} (hung; watchdog killed)"
    if code is not None and code < 0:
        return f"signal {-code}"
    return f"exit {code} (crash)"


class ProgressBoard:
    """Per-worker liveness-progress marks for the hang watchdog.

    A crash produces an exit code; a *hang* produces nothing, and a
    supervisor that only watches exit codes waits on a stuck worker
    forever.  Every supervised role owns a progress counter
    already (actor ticks, learner steps, eval episodes); this board
    makes those counters *observable across processes*: one
    ``mp.Value`` pair per slot label (wall-clock of the last mark + a
    mark count), created by the supervisor BEFORE spawn so the shared
    values ride the worker args' pickle.  ``bump`` is the worker-side
    hot call: two lock-free Value stores.

    ``hung(deadline, grace, now)`` returns the labels whose last mark is
    older than ``deadline`` seconds — except workers that have never
    marked, which get ``deadline + grace`` from their start stamp (the
    start-up grace window: imports and a first build can take minutes).
    Supervisors SIGKILL hung workers and respawn them through the normal
    RestartBudget with EXIT_HUNG.
    """

    def __init__(self, labels: Iterable[str]):
        self._last = {lb: _CTX.Value("d", 0.0, lock=False) for lb in labels}
        self._count = {lb: _CTX.Value("l", 0, lock=False) for lb in labels}

    @property
    def labels(self) -> List[str]:
        return list(self._last)

    def note_start(self, label: str) -> None:
        """Stamp a (re)spawn: the grace window restarts from here."""
        if label in self._last:
            self._last[label].value = time.time()
            self._count[label].value = 0

    def bump(self, label: str, n: int = 1) -> None:
        v = self._last.get(label)
        if v is None:
            return
        v.value = time.time()
        self._count[label].value += n

    def marks(self, label: str) -> int:
        c = self._count.get(label)
        return int(c.value) if c is not None else 0

    def age(self, label: str, now: Optional[float] = None) -> float:
        """Seconds since the label's last mark (inf before note_start)."""
        v = self._last.get(label)
        if v is None or v.value == 0.0:
            return float("inf")
        return (time.time() if now is None else now) - v.value

    def hung(self, deadline: float, grace: float = 0.0,
             now: Optional[float] = None,
             only: Optional[Iterable[str]] = None) -> List[str]:
        """Labels with no progress inside their deadline.  Workers that
        have never bumped (still compiling / importing) answer to
        ``deadline + grace`` instead; workers never started (no
        note_start) are skipped — the supervisor hasn't spawned them."""
        if deadline <= 0:
            return []
        now = time.time() if now is None else now
        out = []
        for lb in (self._last if only is None else only):
            v = self._last.get(lb)
            if v is None or v.value == 0.0:
                continue
            limit = deadline if self.marks(lb) > 0 else deadline + grace
            if now - v.value > limit:
                out.append(lb)
        return out


class RestartBudget:
    """``request_restart(slot)`` returns the respawn delay in seconds —
    exponential backoff capped at ``max_backoff`` when ``backoff`` is on
    (a hot respawn loop against a gateway still holding the dead worker's
    slot would burn the budget), 0.0 otherwise — or None when the slot is
    out of budget.  Call ``note_birth`` whenever a slot (re)spawns."""

    def __init__(self, max_restarts: int = 3, grace: float = 300.0,
                 backoff: bool = False, max_backoff: float = 30.0):
        self.max_restarts = max_restarts
        self.grace = grace
        self.backoff = backoff
        self.max_backoff = max_backoff
        self._restarts: Dict[int, int] = {}
        self._born: Dict[int, float] = {}

    def note_birth(self, slot: int) -> None:
        self._born[slot] = time.monotonic()

    def count(self, slot: int) -> int:
        return self._restarts.get(slot, 0)

    def remaining(self) -> Dict[int, int]:
        """Per-slot restarts left, for every slot ever born."""
        return {slot: max(0, self.max_restarts - self._restarts.get(slot, 0))
                for slot in self._born}

    def request_restart(self, slot: int) -> Optional[float]:
        born = self._born.get(slot)
        # only a RECORDED incarnation that outlived the grace period
        # proves the crash isolated; a slot with no recorded birth must
        # not read as an ancient incarnation (it used to — monotonic==0
        # birth made every unborn crash "old", silently refilling the
        # budget forever for callers that skip note_birth)
        if born is not None and time.monotonic() - born > self.grace:
            self._restarts[slot] = 0  # isolated crash, not a crash loop
        n = self._restarts.get(slot, 0)
        if n >= self.max_restarts:
            return None
        self._restarts[slot] = n + 1
        if not self.backoff:
            return 0.0
        return min(2.0 * 2 ** n, self.max_backoff)
