"""Flow control on the local transports — the port of
pytorch_distributed_tpu/utils/flow.py's local part: ``resolve_flow`` and
``export_env`` (:72-125), the process's shed flags (:128-175:
``set_brownout``, ``telemetry_shed``, ``trace_shed``, ``note_shed``,
``shed_counts``), ``DropOldestRing`` with ``_prov_actor`` (:215-290) and
``shed_overflow`` (:668-683).

Two shed points, both off under the default ``local_policy="block"``
(a full queue then stalls its producer, as before the plane):

- the actor's feeder (memory/feeder.py ``QueueFeeder``): under "shed" a
  full ingest queue parks the chunk in a ``DropOldestRing`` of
  ``feeder_ring`` chunks, which drops its oldest chunk when full;
- the device ingest's pending rows (memory/device_replay.py
  ``DeviceReplayIngest.drain``): under "shed" bounded at
  ``max_pending_rows`` by ``shed_overflow``.

Every drop is counted and stamped with the actor id of the row's
provenance (the ``owner`` for a row without).  Knobs:
``config.FlowParams``, each overridable as ``TPU_APEX_FLOW_<FIELD>``
(``TPU_APEX_FLOW=0`` is ``enabled``); the runtime exports the resolved
plane for its spawn children.  The gateway's overload governor, its
per-slot admission (``GatewayFlow``, ``TokenBucket``) and what climbs
the brownout ladder wait for the fleet planes (ROADMAP.md Queue A item 8);
with no gateway the brownout tier stays 0 here.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
from typing import Any, Dict, List, Optional

from pytorch_distributed_tpu_torch.config import FlowParams

_ENV_PREFIX = "TPU_APEX_FLOW_"
_OFF = ("0", "false", "off", "no", "")


def resolve_flow(fp: Optional[FlowParams] = None) -> FlowParams:
    """``fp`` (or the defaults) with the ``TPU_APEX_FLOW_<FIELD>``
    overrides and the bare ``TPU_APEX_FLOW`` for ``enabled``; a new
    instance, the input is never changed."""
    if fp is None:
        fp = FlowParams()
    changes: Dict[str, Any] = {}
    raw_on = os.environ.get("TPU_APEX_FLOW")
    if raw_on is not None:
        changes["enabled"] = raw_on.strip().lower() not in _OFF
    for f in dataclasses.fields(fp):
        raw = os.environ.get(_ENV_PREFIX + f.name.upper())
        if raw is None:
            continue
        cur = getattr(fp, f.name)
        if isinstance(cur, bool):
            changes[f.name] = raw.strip().lower() not in _OFF
        elif isinstance(cur, int):
            changes[f.name] = int(float(raw))
        elif isinstance(cur, float):
            changes[f.name] = float(raw)
        else:
            changes[f.name] = raw.strip()
    return dataclasses.replace(fp, **changes) if changes else fp


def export_env(fp: FlowParams) -> None:
    """Export a resolved ``FlowParams`` for spawn children (the actors'
    feeders, the ingest's bound); ``setdefault``, so an operator's own
    environment wins."""
    if not fp.enabled:
        os.environ.setdefault("TPU_APEX_FLOW", "0")
    for f in dataclasses.fields(fp):
        val = getattr(fp, f.name)
        if val != f.default:
            os.environ.setdefault(_ENV_PREFIX + f.name.upper(),
                                  ("1" if val is True else
                                   "0" if val is False else str(val)))


# -- the process's brownout tier and shed counts ------------------------------

_brownout_lock = threading.Lock()
_brownout_tier = 0
_shed_counts: Dict[str, int] = {}


def set_brownout(tier: int) -> None:
    global _brownout_tier
    with _brownout_lock:
        _brownout_tier = int(tier)


def brownout_tier() -> int:
    with _brownout_lock:
        return _brownout_tier


def telemetry_shed() -> bool:
    """Tier >= 1: stat pushes are shed."""
    return brownout_tier() >= 1


def trace_shed() -> bool:
    """Tier >= 2: new chunks ship untraced."""
    return brownout_tier() >= 2


def note_shed(kind: str, n: int = 1) -> None:
    with _brownout_lock:
        _shed_counts[kind] = _shed_counts.get(kind, 0) + int(n)


def shed_counts() -> Dict[str, int]:
    with _brownout_lock:
        return dict(_shed_counts)


def reset_shed_state() -> None:
    """Clear the tier and the counts (tests)."""
    global _brownout_tier
    with _brownout_lock:
        _brownout_tier = 0
        _shed_counts.clear()


# -- the bounded drop-oldest buffer --------------------------------------------

def _prov_actor(t, owner: int) -> int:
    """The actor id of a row's provenance; ``owner`` for a row without
    (or with the -1 sentinel)."""
    prov = getattr(t, "prov", None)
    if prov is not None and len(prov) and int(prov[0]) >= 0:
        return int(prov[0])
    return int(owner)


class DropOldestRing:
    """A bounded chunk buffer: ``put`` appends the newest chunk and, past
    ``max_chunks``, drops the oldest, counting its chunks and rows and the
    rows of each actor (``dropped_by_actor``)."""

    def __init__(self, max_chunks: int, owner: int = -1):
        self.max_chunks = max(1, int(max_chunks))
        self.owner = int(owner)
        self._lock = threading.Lock()
        self._buf: collections.deque = collections.deque()
        self.dropped_chunks = 0
        self.dropped_rows = 0
        self.buffered_high = 0  # the most chunks ever held
        self.dropped_by_actor: Dict[int, int] = {}

    def _stamp(self, chunk: list) -> None:
        for row in chunk:
            t = row[0] if isinstance(row, tuple) and not hasattr(
                row, "_fields") else row
            actor = _prov_actor(t, self.owner)
            self.dropped_by_actor[actor] = (
                self.dropped_by_actor.get(actor, 0) + 1)

    def put(self, chunk: list) -> int:
        """Buffer one chunk; returns the rows dropped to make room."""
        dropped = 0
        with self._lock:
            self._buf.append(chunk)
            self.buffered_high = max(self.buffered_high, len(self._buf))
            while len(self._buf) > self.max_chunks:
                old = self._buf.popleft()
                self.dropped_chunks += 1
                self.dropped_rows += len(old)
                dropped += len(old)
                self._stamp(old)
        return dropped

    def pop(self) -> Optional[list]:
        """The oldest buffered chunk, or None."""
        with self._lock:
            return self._buf.popleft() if self._buf else None

    def unpop(self, chunk: list) -> None:
        """Put a popped chunk back at the front."""
        with self._lock:
            self._buf.appendleft(chunk)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    @property
    def buffered_rows(self) -> int:
        with self._lock:
            return sum(len(c) for c in self._buf)


def shed_overflow(pending: List, max_rows: int, counters: Dict[str, int],
                  owner: int = -1) -> List:
    """Drop-oldest over a list of pending rows: returns the newest
    ``max_rows`` and counts the rest into ``counters`` (``shed_rows`` and
    ``shed_by_actor:<id>``)."""
    over = len(pending) - int(max_rows)
    if over <= 0:
        return pending
    dropped, kept = pending[:over], pending[over:]
    counters["shed_rows"] = counters.get("shed_rows", 0) + over
    for t in dropped:
        k = f"shed_by_actor:{_prov_actor(t, owner)}"
        counters[k] = counters.get(k, 0) + 1
    return kept
