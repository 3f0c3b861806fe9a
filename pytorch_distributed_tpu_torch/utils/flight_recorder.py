"""Flight recorder — the port's copy of
pytorch_distributed_tpu/utils/flight_recorder.py (:48-179): a bounded
in-memory ring of recent structured events per role, dumped to
``{log_dir}/blackbox/<role>.jsonl`` when something dies.

Every role appends its last events (supervisor decisions, injected
faults, anomalies, rollbacks) to a ring that costs one lock and a deque
append; the ring is written out as JSONL, one file per role, newest dump
wins, on the paths where a run ends abnormally or recovers:

- a crash of a spawn child (runtime ``_child_main``), before re-raising,
  so the supervisor's respawn erases nothing;
- the SIGTERM preemption notice, before the drain;
- the runtime's supervisor: a dead inference server, a worker restarted
  or fatal, a worker or the learner hung (before the SIGKILL);
- an injected fatal fault (utils/faults.py ``crash``, ``kill``, ``hang``):
  nothing runs after a SIGKILL, so the dump comes first;
- a learner rollback or a fatal divergence (agents/learner.py).

The dump directory is set once per process by ``configure(log_dir)``;
the topology also exports ``TPU_APEX_BLACKBOX_DIR`` (and the run id as
``TPU_APEX_RUN_ID``) so spawn children inherit them.  An unconfigured
process writes nothing.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, List, Optional

_ENV_DIR = "TPU_APEX_BLACKBOX_DIR"
_ENV_RUN = "TPU_APEX_RUN_ID"

DEFAULT_CAPACITY = 512


class FlightRecorder:
    """One role's bounded event ring.  ``record`` is the hot-path call:
    one lock and a deque append (the deque's maxlen drops the oldest)."""

    def __init__(self, role: str, capacity: int = DEFAULT_CAPACITY):
        self.role = role
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self.recorded = 0  # lifetime count (the ring keeps the tail)

    def record(self, kind: str, **fields) -> None:
        evt = {"t": time.time(), "kind": kind}
        evt.update(fields)
        with self._lock:
            self._ring.append(evt)
            self.recorded += 1

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def dump(self, log_dir: Optional[str] = None,
             reason: str = "") -> Optional[str]:
        """Write the ring to ``{log_dir}/blackbox/{role}.jsonl``: a header
        line (reason, pid, run id, counts), then one line per event.
        Returns the path, or None when no dump dir is known or the write
        failed.  A later dump replaces an earlier one."""
        target = log_dir or _dump_dir()
        if not target:
            return None
        events = self.snapshot()
        blackbox = os.path.join(target, "blackbox")
        path = os.path.join(blackbox, f"{_safe_name(self.role)}.jsonl")
        try:
            os.makedirs(blackbox, exist_ok=True)
            with open(path, "w") as f:
                f.write(json.dumps({
                    "t": time.time(), "kind": "dump", "role": self.role,
                    "reason": reason, "pid": os.getpid(),
                    "run_id": run_id(),
                    "events": len(events),
                    "recorded_total": self.recorded,
                }) + "\n")
                for evt in events:
                    f.write(json.dumps(evt) + "\n")
                f.flush()
                os.fsync(f.fileno())
        except OSError:
            # a dump is best effort: a full disk must not turn a clean
            # SIGTERM drain into a crash
            return None
        return path


_lock = threading.Lock()
_recorders: Dict[str, FlightRecorder] = {}
_configured_dir: Optional[str] = None
_configured_run_id: Optional[str] = None


def _safe_name(role: str) -> str:
    return "".join(c if (c.isalnum() or c in "-_.") else "_"
                   for c in role) or "role"


def _dump_dir() -> Optional[str]:
    return _configured_dir or os.environ.get(_ENV_DIR) or None


def run_id() -> Optional[str]:
    """This process's run id: ``configure``'s, else the inherited
    ``TPU_APEX_RUN_ID``.  Dump headers and quarantine files carry it."""
    return _configured_run_id or os.environ.get(_ENV_RUN) or None


def configure(log_dir: str, export_env: bool = False,
              run_id: Optional[str] = None) -> None:
    """Set this process's dump directory (and the run id).
    ``export_env=True`` also exports both, so spawn children inherit them
    (the topology only: a child must not overwrite its parent's)."""
    global _configured_dir, _configured_run_id
    _configured_dir = log_dir
    if run_id:
        _configured_run_id = str(run_id)
    if export_env:
        os.environ[_ENV_DIR] = log_dir
        if run_id:
            os.environ[_ENV_RUN] = str(run_id)


def get_recorder(role: str,
                 capacity: int = DEFAULT_CAPACITY) -> FlightRecorder:
    with _lock:
        rec = _recorders.get(role)
        if rec is None:
            rec = _recorders[role] = FlightRecorder(role, capacity)
        return rec


def dump_all(reason: str = "",
             log_dir: Optional[str] = None) -> List[str]:
    """Dump every recorder of this process; returns the paths written.
    Safe on any path: it only writes files under the log dir and swallows
    I/O errors."""
    with _lock:
        recs = list(_recorders.values())
    paths = []
    for rec in recs:
        p = rec.dump(log_dir=log_dir, reason=reason)
        if p:
            paths.append(p)
    return paths


def reset() -> None:
    """Drop every recorder and the configured dir and run id (test
    isolation)."""
    global _configured_dir, _configured_run_id
    with _lock:
        _recorders.clear()
    _configured_dir = None
    _configured_run_id = None
