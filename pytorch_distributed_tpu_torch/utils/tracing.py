"""Distributed tracing of the actor -> learner experience chunks — the
port of pytorch_distributed_tpu/utils/tracing.py, the whole module
(:1-269): ``TracedChunk`` (a list that keeps its trace id and birth wall
through a spawn queue's pickle, ``__reduce__``), ``Tracer`` (per-span
duration reservoirs, Algorithm R past ``MAX_SAMPLES``, and sampled
per-event rows, drained by ``flush_to`` into a ``MetricsWriter`` as
``trace/<role>/<span>_ms`` histogram rows and span rows), the per-process
registry (``get_tracer``) and the latest-trace latch
(``current_trace``/``set_current_trace``).

Every chunk an actor flushes is minted with a trace id
(memory/feeder.py) and each hop records a span against it:

    enqueue  the actor's put on its ingest queue (a blocking put is
             backpressure)
    feed     queue transit, measured at the learner's drain against the
             chunk's birth wall
    sample   the learner's host batch draw (host rings)
    learn    one learner dispatch

Knobs, read when a tracer is made: ``TPU_APEX_TRACE=0`` turns the plane
off (chunks ship as plain lists, tracers record nothing; on by default)
and ``TPU_APEX_TRACE_SAMPLE`` is the share of trace-carrying events
written as span rows (default 1.0; the histograms count every event).
"""

from __future__ import annotations

import contextlib
import os
import random
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple


def _env_flag(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() not in ("0", "false", "off", "no", "")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def active() -> bool:
    """Is tracing on in this process?  Gates the chunk-wrap fast path
    (memory/feeder.py): with ``TPU_APEX_TRACE=0`` chunks stay plain
    lists — no id mint, no wire columns — so the kill switch removes the
    whole per-chunk cost, not just the span recording."""
    return _env_flag("TPU_APEX_TRACE", True)


def mint_trace_id() -> int:
    """A fresh 63-bit trace id.  urandom-based so ids minted on different
    hosts (remote actors) never need coordination to stay distinct."""
    tid = 0
    while not tid:
        tid = int.from_bytes(os.urandom(8), "big") >> 1
    return tid


def format_trace_id(tid: int) -> str:
    return f"{int(tid):016x}"


class TracedChunk(list):
    """A ``[(Transition, priority), ...]`` chunk carrying trace metadata
    across hops.  Subclasses list so every existing consumer —
    ``pop_chunks``'s extend, the gateway's ``put_chunk``, direct feeds —
    handles it unchanged; the spawn queue's pickling preserves the
    attributes via ``__reduce__``."""

    __slots__ = ("trace_id", "born")

    def __init__(self, items=(), trace_id: Optional[int] = None,
                 born: Optional[float] = None):
        super().__init__(items)
        self.trace_id = mint_trace_id() if trace_id is None else int(trace_id)
        self.born = time.time() if born is None else float(born)

    def __reduce__(self):
        return (TracedChunk, (list(self), self.trace_id, self.born))


# most recent trace id observed by ANY tracer in this process — the
# learner's sample/learn spans attach to it so an end-to-end trace closes
# without threading chunk identity through the jitted hot loop.  A plain
# int assignment (GIL-atomic) on purpose: this is "latest traffic", not
# an exact join, and the hot loop must not take a lock for it.
_last_trace_id = 0


def set_current_trace(tid: int) -> None:
    global _last_trace_id
    _last_trace_id = int(tid)


def current_trace() -> int:
    return _last_trace_id


class Tracer:
    """Per-role span recorder: bounded duration reservoirs (histogram
    feed) plus sampled per-event rows (trace-id feed).  Thread-safe —
    the gateway shares one across its serve threads."""

    MAX_SAMPLES = 4096   # per-span reservoir cap between flushes
    MAX_ROWS = 2048      # per-event row cap between flushes

    def __init__(self, role: str, enabled: Optional[bool] = None,
                 sample: Optional[float] = None):
        self.role = role
        self.enabled = (_env_flag("TPU_APEX_TRACE", True)
                        if enabled is None else enabled)
        self.sample = (_env_float("TPU_APEX_TRACE_SAMPLE", 1.0)
                       if sample is None else sample)
        self._lock = threading.Lock()
        self._hist: Dict[str, List[float]] = {}
        self._count: Dict[str, int] = {}
        self._rows: List[dict] = []
        self._events = 0
        self.dropped_rows = 0  # rows lost to MAX_ROWS (observability)

    # -- recording -----------------------------------------------------------

    def record(self, span: str, dur_ms: float, trace_id: int = 0,
               wall: Optional[float] = None) -> None:
        if not self.enabled:
            return
        if trace_id:
            set_current_trace(trace_id)
        wall = time.time() if wall is None else wall
        with self._lock:
            vals = self._hist.setdefault(span, [])
            n = self._count.get(span, 0) + 1
            self._count[span] = n
            if len(vals) < self.MAX_SAMPLES:
                vals.append(float(dur_ms))
            else:
                # reservoir sampling (Algorithm R): past the cap every
                # event of the window keeps an equal chance of being in
                # the sample, so a stall LATE in a busy window still
                # reaches the percentiles — first-N-kept would blind the
                # tail forensics exactly when traffic is heaviest
                j = random.randrange(n)
                if j < self.MAX_SAMPLES:
                    vals[j] = float(dur_ms)
            self._events += 1
            if trace_id and self._take_sample():
                if len(self._rows) < self.MAX_ROWS:
                    self._rows.append({
                        "span": span, "role": self.role,
                        "trace_id": format_trace_id(trace_id),
                        "dur_ms": round(float(dur_ms), 3), "wall": wall,
                    })
                else:
                    self.dropped_rows += 1

    def _take_sample(self) -> bool:
        # deterministic 1-in-N (no RNG in the hot path; reproducible)
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        period = max(1, int(round(1.0 / self.sample)))
        return self._events % period == 1 or period == 1

    def record_hop(self, span: str, born_wall: float,
                   trace_id: int = 0) -> None:
        """A cross-hop latency measured against the chunk's birth wall
        clock (clamped at 0: cross-host clock skew must not produce
        negative latencies that wreck the histogram floor)."""
        self.record(span, max(0.0, (time.time() - float(born_wall)) * 1e3),
                    trace_id=trace_id)

    @contextlib.contextmanager
    def span(self, name: str, trace_id: int = 0) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, (time.perf_counter() - t0) * 1e3,
                        trace_id=trace_id)

    # -- draining ------------------------------------------------------------

    def drain(self) -> Tuple[Dict[str, List[float]], List[dict],
                             Dict[str, int]]:
        """Return-and-reset (histogram reservoirs, per-event rows, true
        per-span event counts — the reservoirs cap at MAX_SAMPLES but the
        counts never do)."""
        with self._lock:
            hist, self._hist = self._hist, {}
            rows, self._rows = self._rows, []
            counts, self._count = self._count, {}
            return hist, rows, counts

    def flush_to(self, writer, step: int) -> None:
        """Emit everything drained into a utils/metrics.MetricsWriter:
        one histogram row per span (``trace/<role>/<span>_ms``) plus the
        sampled per-event trace rows."""
        hist, rows, counts = self.drain()
        for span, vals in hist.items():
            writer.histogram(f"trace/{self.role}/{span}_ms", vals,
                             step=step, count=counts.get(span))
        for r in rows:
            writer.span(r["span"], role=r["role"], trace_id=r["trace_id"],
                        dur_ms=r["dur_ms"], wall=r["wall"], step=step)


# ---------------------------------------------------------------------------
# per-process registry — one tracer per role name, shared by the role's
# components (e.g. the gateway's serve threads, an actor's feeder +
# harness) so their spans aggregate into one histogram set
# ---------------------------------------------------------------------------

_registry_lock = threading.Lock()
_tracers: Dict[str, Tracer] = {}


def get_tracer(role: str) -> Tracer:
    with _registry_lock:
        t = _tracers.get(role)
        if t is None:
            t = _tracers[role] = Tracer(role)
        return t


def all_tracers() -> List[Tracer]:
    with _registry_lock:
        return list(_tracers.values())


def reset() -> None:
    """Drop all registered tracers and the current-trace latch (test
    isolation; production processes never call this)."""
    global _last_trace_id
    with _registry_lock:
        _tracers.clear()
    _last_trace_id = 0
