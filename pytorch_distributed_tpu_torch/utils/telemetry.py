"""Mission control on one host — the port of
pytorch_distributed_tpu/utils/telemetry.py (:1-1035): bounded
time series of the run's scalar rows, an alert engine over them and an
OpenMetrics endpoint.

- **Aggregation** (``FleetMetrics``, ``SeriesRing``): every role's scalar
  rows land in ring-buffered series per ``(tag, role)`` with coarser
  tiers (raw points for minutes, 10 s buckets for an hour, 60 s buckets
  for six), read by tailing the run's ``scalars.jsonl`` through
  ``utils/metrics.ScalarsTail``.
- **Alerts** (``AlertEngine``): rules in a small language
  (``config.AlertParams.rules``; ``parse_rule``: threshold with a dwell,
  absence, windowed burn rate) evaluated on the poll cadence through
  ``pending -> firing -> resolved``.  Each transition is recorded in the
  ``missionctl`` flight recorder (``kind: "alert"``) and written as an
  ``alert/<rule>`` row (0 ok, 1 pending, 2 firing).
- **OpenMetrics** (``openmetrics_text``, ``OpenMetricsServer``): the
  series' newest points and the alert states as Prometheus text on
  ``GET /metrics`` (stdlib HTTP; port 0 binds a free one).

``MissionControl`` composes them and owns the poll thread; the runtime
builds one when ``MetricsParams.enabled`` and starts and stops it around
the run.  ``ingest_remote`` takes a pushed batch of rows: the fleet's
gateway hands it each ``T_METRICS`` batch, which an actor host's
``MetricsPusher`` (reference :748-893) ships every ``push_s`` from its
own ``scalars.jsonl`` with its NTP-style clock offset.  Knobs:
``config.MetricsParams`` and ``config.AlertParams``, each overridable as
``TPU_APEX_METRICS_<FIELD>`` (the bare ``TPU_APEX_METRICS=1`` is
``enabled``) and ``TPU_APEX_ALERT_<FIELD>`` (``TPU_APEX_ALERT_RULES``
replaces the rule set).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from pytorch_distributed_tpu_torch.utils import flight_recorder
from pytorch_distributed_tpu_torch.utils.metrics import (
    MetricsWriter, ScalarsTail, is_scalar_row,
)

# ---------------------------------------------------------------------------
# knob resolution (config.MetricsParams/AlertParams + env overrides)
# ---------------------------------------------------------------------------

_ENV_PREFIX = "TPU_APEX_METRICS_"
_ALERT_ENV_PREFIX = "TPU_APEX_ALERT_"


def _coerce(cur: Any, raw: str) -> Any:
    """One env string onto a field's type (the perf/health contract,
    plus str fields — ``AlertParams.rules`` is a string DSL)."""
    if isinstance(cur, bool):
        return raw.strip().lower() not in ("0", "false", "off", "no", "")
    if isinstance(cur, int) and not isinstance(cur, bool):
        return int(float(raw))
    if isinstance(cur, float):
        return float(raw)
    return raw


def resolve_metrics(mp=None):
    """MetricsParams + ``TPU_APEX_METRICS_<FIELD>`` env overrides, plus
    the bare ``TPU_APEX_METRICS`` shorthand for ``enabled`` — same
    override-by-env contract as perf/health.resolve.  Returns a NEW
    instance; the input is never mutated (Options rides spawn
    pickles)."""
    from pytorch_distributed_tpu_torch.config import MetricsParams

    if mp is None:
        mp = MetricsParams()
    changes: Dict[str, Any] = {}
    raw_on = os.environ.get("TPU_APEX_METRICS")
    if raw_on is not None:
        changes["enabled"] = raw_on.strip().lower() not in (
            "0", "false", "off", "no", "")
    for f in dataclasses.fields(mp):
        raw = os.environ.get(_ENV_PREFIX + f.name.upper())
        if raw is not None:
            changes[f.name] = _coerce(getattr(mp, f.name), raw)
    return dataclasses.replace(mp, **changes) if changes else mp


def resolve_alerts(ap=None):
    """AlertParams + ``TPU_APEX_ALERT_<FIELD>`` env overrides
    (``TPU_APEX_ALERT_RULES`` replaces the whole rule set)."""
    from pytorch_distributed_tpu_torch.config import AlertParams

    if ap is None:
        ap = AlertParams()
    changes: Dict[str, Any] = {}
    for f in dataclasses.fields(ap):
        raw = os.environ.get(_ALERT_ENV_PREFIX + f.name.upper())
        if raw is not None:
            changes[f.name] = _coerce(getattr(ap, f.name), raw)
    return dataclasses.replace(ap, **changes) if changes else ap


# ---------------------------------------------------------------------------
# bounded multi-tier time series
# ---------------------------------------------------------------------------

class SeriesRing:
    """One metric's bounded history: a raw ring of (wall, value) points
    plus coarser downsampled tiers, so a days-long run keeps minutes of
    full-resolution history and hours of bucket means in a few KB —
    memory is O(tier spans), never O(run).

    Tiers: raw points covering ``raw_span`` seconds (capped at
    ``raw_points``), then ``(interval, span)`` bucket tiers holding
    (t0, count, sum, min, max, last) per interval.  Appends out of
    wall order (merged roles; clock-aligned remote rows) are folded
    into the newest bucket — downsampled telemetry does not need exact
    bucket attribution, it needs bounded memory."""

    TIERS: Tuple[Tuple[float, float], ...] = ((10.0, 3600.0),
                                              (60.0, 21600.0))

    def __init__(self, raw_span: float = 300.0, raw_points: int = 1024,
                 tiers: Optional[Sequence[Tuple[float, float]]] = None):
        self.raw_span = float(raw_span)
        self._raw: collections.deque = collections.deque(
            maxlen=max(8, int(raw_points)))
        # [interval, span, deque of [t0, count, sum, mn, mx, last]]
        self._tiers = [[float(iv), float(span), collections.deque()]
                       for iv, span in (self.TIERS if tiers is None
                                        else tiers)]
        self.appended = 0

    def append(self, wall: float, value: float) -> None:
        wall, value = float(wall), float(value)
        self._raw.append((wall, value))
        self.appended += 1
        newest = self._raw[-1][0]
        while self._raw and newest - self._raw[0][0] > self.raw_span:
            self._raw.popleft()
        for tier in self._tiers:
            interval, span, buckets = tier
            t0 = (wall // interval) * interval
            if buckets and t0 <= buckets[-1][0]:
                b = buckets[-1]  # same or out-of-order bucket: fold
                b[1] += 1
                b[2] += value
                b[3] = min(b[3], value)
                b[4] = max(b[4], value)
                b[5] = value
            else:
                buckets.append([t0, 1, value, value, value, value])
            while buckets and buckets[-1][0] - buckets[0][0] > span:
                buckets.popleft()

    def latest(self) -> Optional[Tuple[float, float]]:
        return self._raw[-1] if self._raw else None

    def recent(self, n: int) -> List[Tuple[float, float]]:
        """Last ``n`` raw points (newest last)."""
        if n <= 0:
            return []
        return list(self._raw)[-n:]

    def window(self, seconds: float, now: Optional[float] = None
               ) -> List[Tuple[float, float]]:
        """Points within the trailing ``seconds`` window: raw where raw
        coverage reaches, extended backwards with bucket means from the
        finest tier that still covers the gap."""
        if now is None:
            now = time.time()
        cut = now - float(seconds)
        out = [(w, v) for w, v in self._raw if w >= cut]
        raw_oldest = self._raw[0][0] if self._raw else now
        if raw_oldest > cut:
            for interval, _span, buckets in self._tiers:
                # only buckets ENTIRELY before the raw coverage: a
                # bucket straddling raw_oldest holds the same points
                # the raw tier already returned
                older = [(b[0], b[2] / b[1]) for b in buckets
                         if cut <= b[0] and b[0] + interval <= raw_oldest]
                if older:
                    out = older + out
                    break
        return out


# ---------------------------------------------------------------------------
# the fleet aggregator
# ---------------------------------------------------------------------------

class FleetMetrics:
    """Tag-keyed fleet time-series store.  Series are kept per
    ``(tag, role)`` so two actors emitting the same tag never interleave
    into one jagged curve; fleet-level reads (``latest``/``window``)
    merge across roles.  Bounded: at most ``max_series`` distinct
    series — overflow is COUNTED (``series_dropped``), never silent."""

    def __init__(self, params=None):
        p = resolve_metrics(params)
        self.params = p
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, str], SeriesRing] = {}
        self.ingested_rows = 0
        self.remote_batches = 0
        self.series_dropped = 0
        self._warned_cap = False

    def _ring(self, tag: str, role: str) -> Optional[SeriesRing]:
        key = (tag, role)
        ring = self._series.get(key)
        if ring is None:
            if len(self._series) >= self.params.max_series:
                self.series_dropped += 1
                if not self._warned_cap:
                    self._warned_cap = True
                    print(f"[telemetry] series cap "
                          f"({self.params.max_series}) reached; new tag "
                          f"{tag!r} dropped (counted, not silent)",
                          flush=True)
                return None
            ring = self._series[key] = SeriesRing(
                raw_span=self.params.raw_span_s,
                raw_points=self.params.raw_points)
        return ring

    def ingest(self, rows: Sequence[dict], offset: float = 0.0,
               source: str = "local") -> int:
        """Absorb scalar rows (MetricsWriter schema: tag/value/wall/role;
        histogram/span/bucket rows are skipped — they summarize at the
        writer already).  ``offset`` is ADDED to each row's wall so a
        remote host's points land on this host's clock.  Returns rows
        absorbed."""
        n = 0
        with self._lock:
            for r in rows:
                if not is_scalar_row(r):
                    continue
                try:
                    wall = float(r.get("wall", 0.0)) + offset
                    value = float(r["value"])
                    tag = str(r["tag"])
                except (TypeError, ValueError, KeyError):
                    continue
                ring = self._ring(tag, str(r.get("role", source)))
                if ring is None:
                    continue
                ring.append(wall, value)
                n += 1
            self.ingested_rows += n
        return n

    # -- fleet-level reads ---------------------------------------------------

    def tags(self) -> List[str]:
        with self._lock:
            return sorted({t for t, _r in self._series})

    def latest(self, tag: str) -> Optional[Tuple[float, float]]:
        """Newest (wall, value) across every role emitting ``tag``."""
        best: Optional[Tuple[float, float]] = None
        with self._lock:
            for (t, _role), ring in self._series.items():
                if t != tag:
                    continue
                pt = ring.latest()
                if pt is not None and (best is None or pt[0] > best[0]):
                    best = pt
        return best

    def window(self, tag: str, seconds: float,
               now: Optional[float] = None) -> List[Tuple[float, float]]:
        """Trailing-window points merged across roles, wall-ordered."""
        out: List[Tuple[float, float]] = []
        with self._lock:
            for (t, _role), ring in self._series.items():
                if t == tag:
                    out.extend(ring.window(seconds, now=now))
        out.sort(key=lambda p: p[0])
        return out

    def series_block(self, tags: Optional[Sequence[str]] = None,
                     points: Optional[int] = None) -> Dict[str, dict]:
        """The status ``series`` block: recent points + latest value per
        tag (roles merged, newest ``points`` kept), for readers that do
        not tail the metrics stream themselves."""
        if points is None:
            points = self.params.series_points
        want = set(tags) if tags is not None else None
        merged: Dict[str, List[Tuple[float, float]]] = {}
        with self._lock:
            for (tag, _role), ring in self._series.items():
                if want is not None and tag not in want:
                    continue
                merged.setdefault(tag, []).extend(ring.recent(points))
        out: Dict[str, dict] = {}
        for tag, pts in merged.items():
            pts.sort(key=lambda p: p[0])
            pts = pts[-points:]
            out[tag] = {
                "points": [[round(w, 3), v] for w, v in pts],
                "latest": pts[-1][1] if pts else None,
            }
        return out


# ---------------------------------------------------------------------------
# alert rules: a small declarative DSL
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative SLO rule over an aggregated series.

    kinds:
      - ``threshold``  — latest value violates ``op value``
        continuously for ``for_s`` seconds;
      - ``absence``    — no sample for ``window_s`` seconds (staleness;
        a series that has NEVER reported is absent by configuration,
        not stale — it does not fire);
      - ``burn_rate``  — over the trailing ``window_s`` window, at
        least ``frac`` of samples violate ``op value`` (the windowed
        error-budget burn read)."""

    name: str
    tag: str
    kind: str                      # threshold | absence | burn_rate
    op: str = ">"
    value: float = 0.0
    for_s: float = 0.0
    window_s: float = 0.0
    frac: float = 0.5


def _dur(text: str) -> float:
    m = re.fullmatch(r"\s*([0-9.]+)\s*(ms|s|m|h)?\s*", text)
    if not m:
        raise ValueError(f"bad duration {text!r}")
    mult = {"ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0,
            None: 1.0}[m.group(2)]
    return float(m.group(1)) * mult


# a real float literal (optional sign, optional exponent with its own
# sign): the lazy [0-9.eE+]+ class both rejected valid "2e-2"
# thresholds and admitted garbage like "+e+." that only failed later
_FLOAT = r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?"

_RULE_RE = re.compile(
    r"^\s*(?:(?P<name>[\w.-]+)\s*:)?\s*(?P<tag>[\w./-]+)\s+"
    r"(?:(?P<absent>absent)\s+(?P<age>[\w.]+)"
    rf"|(?P<op><=|>=|<|>)\s*(?P<value>{_FLOAT})"
    r"(?:\s+frac\s+(?P<frac>[0-9.]+)\s+over\s+(?P<burn>[\w.]+)"
    r"|\s+for\s+(?P<dwell>[\w.]+))?)\s*$")


def parse_rule(spec: str) -> AlertRule:
    """One rule from its DSL line.  Grammar::

        [name:] TAG absent DUR
        [name:] TAG OP VALUE [for DUR]
        [name:] TAG OP VALUE frac FRAC over DUR

    ``OP`` in ``< > <= >=``; ``DUR`` like ``30s``/``5m``/``1h`` (bare
    numbers are seconds).  An omitted name derives from the tag."""
    m = _RULE_RE.match(spec)
    if not m:
        raise ValueError(f"unparseable alert rule {spec!r} (grammar: "
                         f"'[name:] tag absent 30s' | "
                         f"'[name:] tag > 5 for 60s' | "
                         f"'[name:] tag > 5 frac 0.5 over 300s')")
    name = m.group("name") or re.sub(r"[^\w]+", "_", m.group("tag"))
    tag = m.group("tag")
    if m.group("absent"):
        return AlertRule(name=name, tag=tag, kind="absence",
                         window_s=_dur(m.group("age")))
    op, value = m.group("op"), float(m.group("value"))
    if m.group("burn"):
        frac = float(m.group("frac"))
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"burn-rate frac must be in (0, 1] "
                             f"(got {frac} in {spec!r})")
        return AlertRule(name=name, tag=tag, kind="burn_rate", op=op,
                         value=value, frac=frac,
                         window_s=_dur(m.group("burn")))
    dwell = _dur(m.group("dwell")) if m.group("dwell") else 0.0
    return AlertRule(name=name, tag=tag, kind="threshold", op=op,
                     value=value, for_s=dwell)


def parse_rules(specs) -> List[AlertRule]:
    """Rules from a sequence of DSL lines or one ``;``-separated string
    (the env-override form: ``TPU_APEX_ALERT_RULES='a: x absent 30s; b:
    y > 5 for 10s'``).  Duplicate names are a config error — two rules
    writing the same ``alert/<name>`` series would shadow each other."""
    if isinstance(specs, str):
        specs = [s for s in specs.split(";") if s.strip()]
    rules = [parse_rule(s) for s in specs]
    seen: Dict[str, str] = {}
    for r in rules:
        if r.name in seen:
            raise ValueError(f"duplicate alert rule name {r.name!r}")
        seen[r.name] = r.tag
    return rules


# The rule set a bare ``TPU_APEX_METRICS=1`` run evaluates
# (``AlertParams.rules`` ""), the reference's (:422-470), sized for
# production cadences.  A rule over a tag this run never writes never
# fires (the replica, gateway and shard planes come with the fleet
# planes): a threshold needs a sample, an absence needs one first.
# ``overload_shed``: sustained shedding (state 2 of
# ``flow/overload_state``); ``rollout_starvation``: an Anakin loop whose
# rollout share collapsed re-chews a frozen ring; ``replica_churn``:
# lease expiries and fences a rolling minute, a replica crash-looping.
DEFAULT_RULES = (
    "learner_stall: learner/updates_per_s absent 120s",
    "staleness_burn: data/staleness_p50 > 100 frac 0.5 over 300s",
    "priority_collapse: replay/priority_ess_frac < 0.02 for 120s",
    "overload_shed: flow/overload_state >= 2 for 120s",
    "rollout_starvation: anakin/duty_cycle < 0.02 for 120s",
    "replica_membership: replica/members absent 120s",
    "replica_churn: replica/generation_churn > 3 for 120s",
    "gateway_failover: gateway/sync_stale >= 1 for 60s",
    "shard_membership: replay/shard_degraded >= 1 for 60s",
)


_OPS: Dict[str, Callable[[float, float], bool]] = {
    "<": lambda a, b: a < b,
    ">": lambda a, b: a > b,
    "<=": lambda a, b: a <= b,
    ">=": lambda a, b: a >= b,
}

# state -> scalar/OpenMetrics code (resolved collapses back to ok's 0:
# the scalar stream's step function returns to baseline on recovery;
# the distinct "resolved" transition event lives in the blackbox ring)
STATE_CODE = {"ok": 0.0, "pending": 1.0, "firing": 2.0, "resolved": 0.0}


class AlertEngine:
    """The pending→firing→resolved state machine over a FleetMetrics.

    ``evaluate(now)`` runs every rule once; state transitions are
    returned AND recorded — to the flight recorder (``kind: "alert"``,
    the tools/timeline.py leg), and to the scalar stream as
    ``alert/<rule>`` rows (0 ok, 1 pending, 2 firing) when a writer is
    wired.  ``resolved`` is a one-evaluation state that relaxes back to
    ``ok`` on the next pass, so snapshots show the recovery edge."""

    def __init__(self, rules: Sequence[AlertRule], metrics: FleetMetrics,
                 resolve_s: float = 0.0, recorder=None,
                 writer: Optional[MetricsWriter] = None,
                 clock: Callable[[], float] = time.time):
        self.rules = list(rules)
        self.metrics = metrics
        self.resolve_s = float(resolve_s)
        self._recorder = recorder
        self.writer = writer
        self._clock = clock
        self._lock = threading.Lock()
        self._st: Dict[str, dict] = {
            r.name: {"state": "ok", "since": self._clock(),
                     "pending_since": None, "clear_since": None,
                     "value": None, "detail": "", "fired_total": 0,
                     "resolved_total": 0}
            for r in self.rules}
        self.evaluations = 0

    # -- rule checks ---------------------------------------------------------

    def _check(self, rule: AlertRule, now: float
               ) -> Tuple[bool, Optional[float], str]:
        """(violating, observed value, detail) for one rule."""
        if rule.kind == "absence":
            latest = self.metrics.latest(rule.tag)
            if latest is None:
                # never reported: absent by configuration, not stale
                return False, None, "no samples yet"
            age = now - latest[0]
            return (age > rule.window_s, latest[1],
                    f"last sample {age:.1f}s ago "
                    f"(limit {rule.window_s:g}s)")
        if rule.kind == "threshold":
            latest = self.metrics.latest(rule.tag)
            if latest is None:
                return False, None, "no samples yet"
            bad = _OPS[rule.op](latest[1], rule.value)
            return (bad, latest[1],
                    f"latest {latest[1]:g} {rule.op} {rule.value:g}")
        # burn_rate
        pts = self.metrics.window(rule.tag, rule.window_s, now=now)
        if len(pts) < 3:
            return False, None, f"{len(pts)} sample(s) in window"
        bad = sum(1 for _w, v in pts if _OPS[rule.op](v, rule.value))
        frac = bad / len(pts)
        return (frac >= rule.frac, frac,
                f"{frac:.0%} of {len(pts)} samples {rule.op} "
                f"{rule.value:g} over {rule.window_s:g}s "
                f"(budget {rule.frac:.0%})")

    # -- the state machine ---------------------------------------------------

    def _transition(self, rule: AlertRule, st: dict, state: str,
                    now: float) -> dict:
        st["state"] = state
        st["since"] = now
        # "rule_kind", not "kind": the flight-recorder event's own kind
        # is "alert" (what tools/timeline.py keys its loud lines on)
        evt = {"rule": rule.name, "tag": rule.tag, "state": state,
               "rule_kind": rule.kind, "value": st["value"],
               "detail": st["detail"], "wall": now}
        if self._recorder is not None:
            self._recorder.record("alert", **{k: v for k, v in evt.items()
                                              if k != "wall"})
        if self.writer is not None:
            self.writer.scalar(f"alert/{rule.name}", STATE_CODE[state],
                               step=st["fired_total"], wall=now)
            self.writer.flush()
        return evt

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """One pass over every rule; returns the transitions it made."""
        if now is None:
            now = self._clock()
        transitions: List[dict] = []
        with self._lock:
            self.evaluations += 1
            for rule in self.rules:
                st = self._st[rule.name]
                violating, value, detail = self._check(rule, now)
                st["value"], st["detail"] = value, detail
                if violating:
                    st["clear_since"] = None
                    if st["state"] in ("ok", "resolved"):
                        st["pending_since"] = now
                        transitions.append(
                            self._transition(rule, st, "pending", now))
                    if (st["state"] == "pending"
                            and now - st["pending_since"] >= rule.for_s):
                        st["fired_total"] += 1
                        transitions.append(
                            self._transition(rule, st, "firing", now))
                else:
                    if st["state"] == "pending":
                        # never fired: relax quietly (recorded, but no
                        # "resolved" — there was nothing to resolve)
                        transitions.append(
                            self._transition(rule, st, "ok", now))
                    elif st["state"] == "firing":
                        if st["clear_since"] is None:
                            st["clear_since"] = now
                        if now - st["clear_since"] >= self.resolve_s:
                            st["resolved_total"] += 1
                            transitions.append(self._transition(
                                rule, st, "resolved", now))
                    elif st["state"] == "resolved":
                        st["state"] = "ok"
                        st["since"] = now
        return transitions

    def snapshot(self) -> List[dict]:
        """Per-rule state for the STATUS ``alerts`` block (and the
        OpenMetrics alert gauges).  Plain JSON-able dicts."""
        now = self._clock()
        with self._lock:
            out = []
            for rule in self.rules:
                st = self._st[rule.name]
                out.append({
                    "rule": rule.name, "tag": rule.tag,
                    "kind": rule.kind, "state": st["state"],
                    "age": round(now - st["since"], 3),
                    "value": st["value"], "detail": st["detail"],
                    "fired_total": st["fired_total"],
                    "resolved_total": st["resolved_total"],
                })
            return out

    def firing(self) -> List[str]:
        with self._lock:
            return [r.name for r in self.rules
                    if self._st[r.name]["state"] == "firing"]


# ---------------------------------------------------------------------------
# OpenMetrics / Prometheus text exposition
# ---------------------------------------------------------------------------

_METRIC_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(tag: str) -> str:
    name = _METRIC_NAME_RE.sub("_", tag)
    if name and name[0].isdigit():
        name = "_" + name
    return f"tpu_apex_{name}"


def _label(value: str) -> str:
    """Prometheus label-value escaping (backslash, quote, newline):
    role/host labels come off the wire from pushers — one misbehaving
    value must not make the whole /metrics page unparseable."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def openmetrics_text(metrics: FleetMetrics,
                     engine: Optional[AlertEngine] = None) -> str:
    """The aggregated fleet state in Prometheus text format (0.0.4 —
    the dialect every scraper speaks; terminated with the OpenMetrics
    ``# EOF`` marker, which classic parsers read as a comment).  One
    gauge per tag with the role as a label, millisecond timestamps from
    the CAPTURE wall (not scrape time), plus per-rule alert-state
    gauges and the aggregator's own ingest counters."""
    lines: List[str] = []
    with metrics._lock:
        items = sorted(metrics._series.items())
        per_tag: Dict[str, List[Tuple[str, Tuple[float, float]]]] = {}
        for (tag, role), ring in items:
            pt = ring.latest()
            if pt is not None:
                per_tag.setdefault(tag, []).append((role, pt))
    for tag, rows in per_tag.items():
        name = _metric_name(tag)
        lines.append(f"# HELP {name} fleet series {tag}")
        lines.append(f"# TYPE {name} gauge")
        for role, (wall, value) in rows:
            lines.append(f'{name}{{role="{_label(role)}"}} {value:g} '
                         f"{int(wall * 1000)}")
    if engine is not None:
        lines.append("# HELP tpu_apex_alert_state alert rule state "
                     "(0 ok, 1 pending, 2 firing)")
        lines.append("# TYPE tpu_apex_alert_state gauge")
        snap = engine.snapshot()
        for a in snap:
            lines.append(
                f'tpu_apex_alert_state{{rule="{_label(a["rule"])}",'
                f'tag="{_label(a["tag"])}"}} '
                f"{STATE_CODE.get(a['state'], 0.0):g}")
        lines.append("# TYPE tpu_apex_alerts_firing gauge")
        lines.append(f"tpu_apex_alerts_firing "
                     f"{sum(1 for a in snap if a['state'] == 'firing')}")
    lines.append("# TYPE tpu_apex_telemetry_rows_ingested counter")
    lines.append(f"tpu_apex_telemetry_rows_ingested "
                 f"{metrics.ingested_rows}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


class OpenMetricsServer:
    """Opt-in stdlib-HTTP scrape endpoint (``GET /metrics``) — standard
    Prometheus tooling watches the fleet with zero custom client code.
    Daemon-threaded; ``port=0`` binds an ephemeral port (tests), the
    production default lives in ``MetricsParams.openmetrics_port``."""

    def __init__(self, text_fn: Callable[[], str],
                 host: str = "0.0.0.0", port: int = 9108):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        server = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - stdlib API name
                if self.path.split("?")[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                try:
                    body = text_fn().encode()
                except Exception as e:  # noqa: BLE001 - scrape never kills
                    self.send_error(500, repr(e)[:200])
                    return
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; "
                                 "charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                server.scrapes += 1

            def log_message(self, *args):  # noqa: D102
                pass  # scrape chatter must not pollute the run's stdout

        self.scrapes = 0
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="openmetrics", daemon=True)
        self._thread.start()

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError:
            pass
        self._thread.join(2.0)


# ---------------------------------------------------------------------------
# remote push (the T_METRICS client side)
# ---------------------------------------------------------------------------

class MetricsPusher:
    """Fleet-host leg of the aggregator: tails THIS host's
    ``scalars.jsonl`` (the same ``ScalarsTail`` cursor the local ingest
    uses) and pushes each poll's scalar deltas to the learner-host
    gateway over the sessionless ``T_METRICS`` verb on the
    ``push_s`` cadence.

    Wall-clock alignment: the T_METRICS reply carries the gateway's
    wall clock; the pusher estimates its offset to it NTP-style off the
    RPC midpoint (EWMA-smoothed — the same estimator DcnClient uses for
    ``clock_sync``) and ships the estimate with every batch, so the
    gateway-side aggregator lands this host's points on the learner
    host's time axis.  The FIRST push is an empty offset-estimation
    handshake: rows only travel once an offset estimate exists, so a
    badly skewed host never pollutes the fleet series with unaligned
    points.  Push failures are counted and retried next cadence — the
    telemetry plane must never backpressure the host it watches."""

    # rows buffered across failed pushes before the OLDEST are shed
    # (counted as ``dropped_rows``, never silent): an actor host whose
    # coordinator is down for days must not hoard its whole metrics
    # backlog in memory — telemetry is a lossy-tolerable plane, the
    # host it watches is not
    MAX_PENDING = 10_000

    def __init__(self, address: Tuple[str, int], log_dir: str,
                 params=None, host: Optional[str] = None,
                 clock: Callable[[], float] = time.time):
        self.address = address
        self.params = resolve_metrics(params)
        self._tail = ScalarsTail(log_dir, max_bytes=1 << 20)
        self._host = host or os.uname().nodename
        self._clock = clock
        self.offset: Optional[float] = None
        self.pushed_rows = 0
        self.push_errors = 0
        self.dropped_rows = 0
        # brownout tier 1 (the telemetry rung): the gateway's
        # T_METRICS reply carries ``brownout`` while the ladder is
        # engaged; this pusher then sheds its pending rows (counted
        # here) until a reply clears it — metrics traffic yields to
        # the experience plane first, and never silently.
        self.brownout = 0
        self.brownout_shed_rows = 0
        self._warned_drop = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._pending: List[dict] = []

    def _rpc(self, rows: List[dict]) -> dict:
        from pytorch_distributed_tpu_torch.parallel.dcn import push_metrics

        t0 = self._clock()
        reply = push_metrics(self.address, rows, offset=self.offset,
                             host=self._host)
        mid = (t0 + self._clock()) / 2.0
        gw_wall = reply.get("wall")
        if isinstance(gw_wall, (int, float)):
            sample = float(gw_wall) - mid
            self.offset = (sample if self.offset is None
                           else 0.9 * self.offset + 0.1 * sample)
        try:
            self.brownout = int(reply.get("brownout", 0) or 0)
        except (TypeError, ValueError):
            self.brownout = 0
        return reply

    def push_once(self) -> int:
        """One cadence: tail new rows, (re)estimate the offset, push.
        Returns rows accepted by the gateway.  A failed push RETAINS
        its batch for the next cadence (re-prepended, order kept) up
        to ``MAX_PENDING`` rows; beyond that the oldest are shed and
        counted."""
        self._pending.extend(r for r in self._tail.poll()
                             if is_scalar_row(r))
        if self.brownout >= 1 and self._pending:
            # the telemetry rung of the brownout ladder: shed this
            # cadence's rows (counted), then ping with an empty batch
            # so recovery — a reply without ``brownout`` — is observed
            self.brownout_shed_rows += len(self._pending)
            self._pending = []
            try:
                self._rpc([])
            except (ConnectionError, OSError):
                self.push_errors += 1
            return 0
        if len(self._pending) > self.MAX_PENDING:
            shed = len(self._pending) - self.MAX_PENDING
            del self._pending[:shed]
            self.dropped_rows += shed
            if not self._warned_drop:
                self._warned_drop = True
                print(f"[telemetry] pusher backlog over "
                      f"{self.MAX_PENDING} rows (gateway unreachable?);"
                      f" shedding oldest (counted, not silent)",
                      flush=True)
        batch: List[dict] = []
        try:
            if self.offset is None:
                self._rpc([])  # offset handshake before any row travels
            if not self._pending:
                return 0
            batch, self._pending = self._pending, []
            reply = self._rpc(batch)
            if reply.get("error"):
                self.push_errors += 1
                self._pending = batch + self._pending
                return 0
            n = int(reply.get("accepted", 0))
            self.pushed_rows += n
            return n
        except (ConnectionError, OSError):
            # the batch survives the blip: next cadence retries it
            # ahead of newer rows (the gateway-restart soak scenario)
            self.push_errors += 1
            self._pending = batch + self._pending
            return 0

    def start(self) -> None:
        if self._thread is not None:
            return

        def _loop() -> None:
            while not self._stop.wait(self.params.push_s):
                self.push_once()
            self.push_once()  # final drain on stop

        self._thread = threading.Thread(target=_loop,
                                        name="metrics-pusher",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None


# ---------------------------------------------------------------------------
# mission control: the composed plane
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# mission control: the composed plane
# ---------------------------------------------------------------------------

class MissionControl:
    """One run's telemetry brain: aggregator + alert engine + (opt-in)
    OpenMetrics endpoint, polled by one background thread.

    - local ingest: tails ``{log_dir}/scalars.jsonl`` (every co-located
      role's writer appends there) via ScalarsTail;
    - remote ingest: ``ingest_remote`` takes a pushed batch (the
      gateway's ``T_METRICS`` sink);
    - alert transitions land in the flight recorder (role
      ``missionctl``) and — when a log dir exists — as
      ``alert/<rule>`` rows in the same scalar stream;
    - ``status_block()`` is the ``alerts`` + ``series`` blocks of a
      status reply."""

    ROLE = "missionctl"

    # tags the status series block always tries to carry (the fleet's
    # vital signs); rule tags are added automatically.  The second row
    # is the reference logger's learning curve — present on EVERY run,
    # so a fleet without the perf plane still gets trend lines.
    KEY_TAGS = ("learner/updates_per_s", "learner/mfu",
                "actor/env_frames_per_s", "data/staleness_p50",
                "replay/priority_ess_frac", "flow/overload_state",
                "anakin/duty_cycle", "anakin/replay_fill",
                "replica/members", "replica/generation_churn",
                "replay/shard_members", "replay/shard_mass_skew",
                "learner/critic_loss", "evaluator/avg_reward",
                "actor/avg_reward", "learner/steps_per_sec")

    def __init__(self, log_dir: Optional[str], metrics_params=None,
                 alert_params=None, clock: Callable[[], float] = time.time):
        self.params = resolve_metrics(metrics_params)
        self.alert_params = resolve_alerts(alert_params)
        self.log_dir = log_dir
        self.metrics = FleetMetrics(self.params)
        self._tail = (ScalarsTail(log_dir, max_bytes=1 << 20)
                      if log_dir else None)
        self._writer = (MetricsWriter(log_dir, enable_tensorboard=False,
                                      role=self.ROLE)
                        if log_dir else None)
        rules: Sequence[AlertRule] = ()
        if self.alert_params.enabled:
            rules = parse_rules(self.alert_params.rules or DEFAULT_RULES)
        self.engine = AlertEngine(
            rules, self.metrics, resolve_s=self.alert_params.resolve_s,
            recorder=flight_recorder.get_recorder(self.ROLE),
            writer=self._writer, clock=clock)
        self.exporter: Optional[OpenMetricsServer] = None
        if self.params.openmetrics:
            self.exporter = OpenMetricsServer(
                self.openmetrics_text, port=self.params.openmetrics_port)
            print(f"[telemetry] OpenMetrics endpoint on "
                  f":{self.exporter.port}/metrics", flush=True)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- ingest --------------------------------------------------------------

    def poll(self, now: Optional[float] = None) -> List[dict]:
        """One cadence: tail local rows, evaluate alerts.  Returns the
        alert transitions this pass made (drills assert on them)."""
        if self._tail is not None:
            self.metrics.ingest(self._tail.poll(), source="local")
        return self.engine.evaluate(now=now)

    def ingest_remote(self, payload: dict) -> int:
        """One pushed batch of another host's rows.  ``offset``
        (the pusher's NTP-style estimate of THIS host's clock minus its
        own) aligns the rows' walls onto our time axis."""
        rows = payload.get("rows") or []
        try:
            offset = float(payload.get("offset") or 0.0)
        except (TypeError, ValueError):
            offset = 0.0
        self.metrics.remote_batches += 1
        return self.metrics.ingest(rows, offset=offset,
                                   source=str(payload.get("host",
                                                          "remote")))

    # -- reads ---------------------------------------------------------------

    def _series_tags(self) -> List[str]:
        tags = [t.strip() for t in
                self.params.series_tags.split(",") if t.strip()]
        tags.extend(self.KEY_TAGS)
        tags.extend(r.tag for r in self.engine.rules)
        have = set(self.metrics.tags())
        out, seen = [], set()
        for t in tags:
            if t in have and t not in seen:
                seen.add(t)
                out.append(t)
        return out

    def status_block(self) -> dict:
        """The gateway-STATUS contribution: ``alerts`` (per-rule state)
        and ``series`` (recent points for the vital-sign tags)."""
        return {"alerts": self.engine.snapshot(),
                "series": self.metrics.series_block(self._series_tags()),
                "telemetry": {
                    "rows": self.metrics.ingested_rows,
                    "remote_batches": self.metrics.remote_batches,
                    "series_dropped": self.metrics.series_dropped,
                }}

    def openmetrics_text(self) -> str:
        return openmetrics_text(self.metrics, self.engine)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return

        def _loop() -> None:
            while not self._stop.wait(self.params.poll_s):
                try:
                    self.poll()
                except Exception as e:  # noqa: BLE001 - watch, never kill
                    print(f"[telemetry] poll failed: {e!r}", flush=True)
        self._thread = threading.Thread(target=_loop,
                                        name="mission-control",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
        try:
            self.poll()  # final tail drain + alert pass
        except Exception:  # noqa: BLE001
            pass
        if self.exporter is not None:
            self.exporter.close()
            self.exporter = None
        if self._writer is not None:
            self._writer.close()
            self._writer = None
            self.engine.writer = None
