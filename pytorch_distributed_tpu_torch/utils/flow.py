"""Flow control — the port of pytorch_distributed_tpu/utils/flow.py:
``resolve_flow`` and ``export_env`` (:72-125), the process's shed flags
(:128-175: ``set_brownout``, ``telemetry_shed``, ``trace_shed``,
``note_shed``, ``shed_counts``), ``TokenBucket`` (:177-213),
``DropOldestRing`` with ``_prov_actor`` (:215-290), the gateway's
``OverloadGovernor`` (:293-405) and ``GatewayFlow`` (:406-667), and
``shed_overflow`` (:668-683).

Two local shed points, both off under the default
``local_policy="block"`` (a full queue then stalls its producer, as
before the plane):

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
plane for its spawn children.

On the wire (parallel/dcn.py): the gateway's ``GatewayFlow`` runs an
``OverloadGovernor`` (healthy -> throttled -> shedding, one state per
``dwell_s`` of pressure, one step down per ``recover_s`` below
``recover_at``; inside shedding a brownout tier climbs one rung per
``brownout_dwell_s``) off the ingest queue's fill, grants per-slot
credits on every ``T_CLOCK`` ack (no field while healthy, bucket-metered
while throttled, 0 while shedding), sheds a chunk only at tier 3 with
the slot's bucket dry, and keeps the conservation ledger ``minted =
ingested + dropped + quarantined (+ buffered)``.  A ``DcnClient`` at
grant 0 parks chunks in a ``DropOldestRing`` of ``client_ring`` chunks
and latches the tier its acks carry (``set_brownout``).  Every clock is
injectable, so a test drives the governor step by step.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from pytorch_distributed_tpu_torch.config import FlowParams

_ENV_PREFIX = "TPU_APEX_FLOW_"
_OFF = ("0", "false", "off", "no", "")

# overload state -> the ``flow/overload_state`` scalar
STATE_CODE = {"healthy": 0.0, "throttled": 1.0, "shedding": 2.0}


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


# -- the per-slot token bucket ------------------------------------------------

class TokenBucket:
    """A refill-on-read token bucket: ``take`` consumes on success,
    ``level`` is what a credit grant reads."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._lock = threading.Lock()
        self._tokens = self.burst
        self._last = clock()

    def _refill(self, now: float) -> None:
        self._tokens = min(self.burst,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now

    def take(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill(self._clock())
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def level(self) -> float:
        with self._lock:
            self._refill(self._clock())
            return self._tokens


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


# -- the gateway's overload state machine --------------------------------------

class OverloadGovernor:
    """``healthy -> throttled -> shedding`` off a 0..1 pressure.  Pressure
    held at or above the next state's threshold for ``dwell_s`` climbs one
    state; held below ``recover_at`` for ``recover_s`` steps down one; the
    band between holds.  Inside shedding the brownout tier climbs one
    rung per ``brownout_dwell_s`` up to 3.  Each transition is an
    ``overload`` flight-recorder event and, with a writer, a
    ``flow/overload_state`` and ``flow/brownout_tier`` row."""

    STATES = ("healthy", "throttled", "shedding")

    def __init__(self, params=None, recorder=None, writer=None,
                 clock: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time):
        self.params = resolve_flow(params)
        self._recorder = recorder
        self.writer = writer
        self._clock = clock
        self._wall = wall
        self._lock = threading.Lock()
        self.state = "healthy"
        self.tier = 0
        self.transitions = 0
        self._above_since: Optional[float] = None
        self._below_since: Optional[float] = None
        self._tier_since: Optional[float] = None
        self.last_pressure = 0.0

    def _record(self, now: float, pressure: float, why: str) -> None:
        self.transitions += 1
        if self._recorder is not None:
            self._recorder.record("overload", state=self.state,
                                  tier=self.tier,
                                  pressure=round(pressure, 4), why=why)
        if self.writer is not None:
            try:
                self.writer.scalar("flow/overload_state",
                                   STATE_CODE[self.state] + 0.0,
                                   step=self.transitions,
                                   wall=self._wall())
                self.writer.scalar("flow/brownout_tier", float(self.tier),
                                   step=self.transitions,
                                   wall=self._wall())
                self.writer.flush()
            except Exception:  # noqa: BLE001 - telemetry must not stop flow
                pass

    def update(self, pressure: float,
               now: Optional[float] = None) -> Optional[str]:
        """One evaluation; the new state on a transition (of state or
        tier), else None."""
        p = self.params
        if now is None:
            now = self._clock()
        with self._lock:
            self.last_pressure = float(pressure)
            level = self.STATES.index(self.state)
            next_thresh = p.throttle_at if level == 0 else p.shed_at
            changed = False
            if level < 2 and pressure >= next_thresh:
                self._below_since = None
                if self._above_since is None:
                    self._above_since = now
                if now - self._above_since >= p.dwell_s:
                    level += 1
                    self.state = self.STATES[level]
                    self._above_since = now  # the next rung dwells anew
                    if self.state == "shedding":
                        self.tier = 1
                        self._tier_since = now
                    changed = True
                    self._record(now, pressure, "escalate")
            elif pressure < p.recover_at:
                self._above_since = None
                if self._below_since is None:
                    self._below_since = now
                if level > 0 and now - self._below_since >= p.recover_s:
                    level -= 1
                    self.state = self.STATES[level]
                    self._below_since = now  # the next step dwells anew
                    self.tier = 0 if self.state != "shedding" else self.tier
                    self._tier_since = None
                    changed = True
                    self._record(now, pressure, "recover")
            else:
                # the hysteresis band: hold, and reset both dwells
                self._above_since = None
                self._below_since = None
            if (self.state == "shedding" and self.tier < 3
                    and self._tier_since is not None
                    and now - self._tier_since >= p.brownout_dwell_s):
                self.tier += 1
                self._tier_since = now
                changed = True
                self._record(now, pressure, "brownout")
            return self.state if changed else None


# -- the gateway's admission plane ---------------------------------------------

class GatewayFlow:
    """Per-slot admission, credit grants and the conservation ledger of
    one ``DcnGateway``.  ``admit`` runs on every EXP frame: it updates the
    governor off ``pressure`` at most every ``update_every`` seconds,
    takes a token from the slot's bucket, and refuses (sheds, counted)
    only at tier 3 with the bucket dry.  ``grant`` sizes the credits of
    the slot's next ack.  Clients report cumulative ``minted``,
    ``acked``, ``acked_bytes``, ``dropped`` and ``buffered`` on their
    ticks (``on_client_report``); ``conservation`` checks ``minted <=
    ingested + dropped + shed + quarantined + buffered`` live, and the
    byte ledger ``acked_bytes <= ingested + rejected + shed bytes``."""

    def __init__(self, params=None, pressure=None, recorder=None,
                 writer=None, clock: Callable[[], float] = time.monotonic,
                 update_every: float = 0.25):
        self.params = resolve_flow(params)
        self.pressure = pressure
        self._clock = clock
        self._update_every = float(update_every)
        self.governor = OverloadGovernor(self.params, recorder=recorder,
                                         writer=writer, clock=clock)
        self._recorder = recorder
        self._lock = threading.Lock()
        self._buckets: Dict[int, TokenBucket] = {}
        self._next_update = 0.0
        self.ingested_rows = 0
        self.shed_chunks = 0
        self.shed_rows: Dict[int, int] = {}
        self.client_reports: Dict[int, Dict[str, int]] = {}
        self._shed_logged = 0
        # every acked EXP payload's bytes land in one of these
        self.ingested_bytes = 0
        self.rejected_bytes = 0
        self.shed_bytes = 0
        self.shed_bytes_by_tier: Dict[int, int] = {}

    def _bucket(self, slot: int) -> TokenBucket:
        with self._lock:
            b = self._buckets.get(slot)
            if b is None:
                b = self._buckets[slot] = TokenBucket(
                    self.params.bucket_rate, self.params.bucket_burst,
                    clock=self._clock)
            return b

    def refresh(self, now: Optional[float] = None) -> None:
        """A governor update off the pressure provider, at most every
        ``update_every`` seconds; a probe that raises reads healthy."""
        if now is None:
            now = self._clock()
        with self._lock:
            if now < self._next_update:
                return
            self._next_update = now + self._update_every
        p = 0.0
        if self.pressure is not None:
            try:
                p = float(self.pressure())
            except Exception:  # noqa: BLE001 - unknown pressure is healthy
                p = 0.0
        self.governor.update(p, now=now)

    def admit(self, slot: Optional[int], rows: int,
              nbytes: int = 0) -> bool:
        """Admission of one decoded EXP chunk: False (shed, counted) only
        at tier 3 with the slot's bucket dry."""
        self.refresh()
        s = -1 if slot is None else int(slot)
        has_tokens = self._bucket(s).take(1.0)
        if self.governor.tier >= 3 and not has_tokens:
            with self._lock:
                self.shed_chunks += 1
                self.shed_rows[s] = self.shed_rows.get(s, 0) + int(rows)
                self.shed_bytes += int(nbytes)
                tier = self.governor.tier
                self.shed_bytes_by_tier[tier] = \
                    self.shed_bytes_by_tier.get(tier, 0) + int(nbytes)
                self._shed_logged += 1
                log_it = self._shed_logged <= 3
            if self._recorder is not None:
                self._recorder.record("flow-shed", slot=s, rows=int(rows),
                                      tier=self.governor.tier)
            if log_it:
                print(f"[flow] tier-3 brownout: shed {rows}-row chunk "
                      f"from slot {s} (bucket dry)", flush=True)
            return False
        return True

    def note_ingested(self, rows: int) -> None:
        """Rows that entered the learn path (admitted and clean)."""
        with self._lock:
            self.ingested_rows += int(rows)

    def note_ingested_bytes(self, nbytes: int) -> None:
        """An admitted EXP frame's payload bytes (also when the
        quarantine empties it)."""
        with self._lock:
            self.ingested_bytes += int(nbytes)

    def note_rejected_bytes(self, nbytes: int) -> None:
        """A schema-rejected (and acked) EXP frame's payload bytes."""
        with self._lock:
            self.rejected_bytes += int(nbytes)

    def grant(self, slot: Optional[int]) -> Optional[int]:
        """The credits of the slot's next ack; None (no field) while
        healthy."""
        self.refresh()
        state = self.governor.state
        if state == "healthy":
            return None
        if state == "shedding":
            return 0
        s = -1 if slot is None else int(slot)
        return max(0, min(self.params.credits_throttled,
                          int(self._bucket(s).level())))

    def on_client_report(self, slot: Optional[int], report: dict) -> None:
        """A client's cumulative counters off its tick (idempotent under
        a retransmit)."""
        if slot is None or not isinstance(report, dict):
            return
        clean: Dict[str, int] = {}
        for k in ("minted", "acked", "acked_bytes", "dropped",
                  "buffered"):
            try:
                clean[k] = int(report.get(k, 0))
            except (TypeError, ValueError):
                clean[k] = 0
        with self._lock:
            self.client_reports[int(slot)] = clean

    def conservation(self, quarantined: int = 0) -> dict:
        """The ledger.  Live it flags only ``minted > accounted`` (client
        counters lag by a tick, the gateway's are current); with no
        reporting slot it has no verdict."""
        with self._lock:
            reports = {s: dict(r) for s, r in self.client_reports.items()}
            gw_shed = sum(self.shed_rows.values())
            ingested = self.ingested_rows
            ingested_b = self.ingested_bytes
            rejected_b = self.rejected_bytes
            shed_b = self.shed_bytes
        minted = sum(r["minted"] for r in reports.values())
        dropped = sum(r["dropped"] for r in reports.values())
        buffered = sum(r["buffered"] for r in reports.values())
        acked_b = sum(r.get("acked_bytes", 0) for r in reports.values())
        out = {
            "minted": minted,
            "ingested": ingested,
            "dropped_client": dropped,
            "shed_gateway": gw_shed,
            "quarantined": int(quarantined),
            "buffered_client": buffered,
            "acked_bytes": acked_b,
            "ingested_bytes": ingested_b,
            "rejected_bytes": rejected_b,
            "shed_bytes": shed_b,
            "reporting_slots": sorted(reports),
        }
        if reports:
            accounted = (ingested + dropped + gw_shed
                         + int(quarantined) + buffered)
            out["accounted"] = accounted
            out["balanced"] = bool(minted <= accounted)
            accounted_b = ingested_b + rejected_b + shed_b
            out["accounted_bytes"] = accounted_b
            out["bytes_balanced"] = bool(acked_b <= accounted_b)
        return out

    def status_block(self, quarantined: int = 0) -> dict:
        """The STATUS ``flow`` block: state, tier, per-slot credits and
        shed counts, the clients' reports, each slot's share of the
        drops, and the conservation ledger."""
        with self._lock:
            slots = sorted(set(self._buckets) | set(self.shed_rows)
                           | set(self.client_reports))
            shed = {str(s): n for s, n in sorted(self.shed_rows.items())}
            reports = {str(s): dict(r)
                       for s, r in sorted(self.client_reports.items())}
        drops = {s: (shed.get(s, 0) + reports.get(s, {}).get("dropped", 0))
                 for s in (str(x) for x in slots)}
        total_drops = sum(drops.values())
        return {
            "state": self.governor.state,
            "tier": self.governor.tier,
            "pressure": round(self.governor.last_pressure, 4),
            "transitions": self.governor.transitions,
            "credits": {str(s): self.grant(s) for s in slots
                        if self.governor.state != "healthy"},
            "shed_rows": shed,
            "shed_chunks": self.shed_chunks,
            "client": reports,
            "drop_share": ({s: round(n / total_drops, 4)
                            for s, n in drops.items() if n}
                           if total_drops else {}),
            "conservation": self.conservation(quarantined=quarantined),
        }


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
