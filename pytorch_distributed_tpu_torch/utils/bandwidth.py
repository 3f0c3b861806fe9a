"""The bandwidth X-ray: byte counts of the spawn queues and the replay
rings — the port of pytorch_distributed_tpu/utils/bandwidth.py's local
planes: ``resolve_bandwidth`` and ``export_env`` (:81-126), the sizing
helpers ``payload_nbytes``, ``chunk_nbytes`` and ``replay_nbytes``
(:149-190), the frame verbs (``register_verbs``, ``verb_name``,
:137-148), ``LinkAccountant``'s counters and export (``register_socket``,
``note``, ``note_frame``, ``note_transitions``, ``note_round``,
``set_gauge``, ``totals``, ``snapshot``, ``bytes_per_transition``,
``emit_scalars``, ``status_block``; :195-382) and the process-wide plane
with its hooks (:394-528: ``register_socket``, ``note_frame``,
``note_spawn``, ``note_device_replay``, ``note_host_replay``,
``note_round``, ``status_block``).

A ``LinkAccountant`` keeps cumulative ``(bytes, frames)`` per ``link x
verb x slot x direction`` under a lock never held across I/O.  The port
stamps two links: ``spawn``, the actors' ingest queues (verb ``mint`` at
the feeder's flush, ``drain`` at the learner's read; memory/feeder.py),
and the rings' occupancy gauges ``replay/hbm_bytes`` (device rings, one
shot at attach) and ``replay/host_bytes`` (host rings, at construction).
``ckpt/epoch_bytes`` is the checkpoint saver's (utils/checkpoint.py).
The DCN wire (parallel/dcn.py) tags its sockets by link: ``gateway``
(accepted connections, the slot known at HELLO), ``client`` (actor
sessions), ``replica`` (a ``ReplicaClient``'s lease and round sockets,
slot the replica id), ``sync`` (a standby's ``T_SYNC`` pulls) and
``probe`` (the sessionless ``T_STATUS``, ``T_PROFILE`` and ``T_METRICS``
calls); the verbs are the frame types' names, and each completed
replica round is a ``note_round`` (``wire/replica_bytes_per_round``).
The learner writes ``emit_scalars`` on its stats cadence:
``wire/<link>/bytes_per_s`` from the previous emit, and the gauges.

Bytes are array payload bytes (``.nbytes`` of every numpy array and
torch tensor reachable through NamedTuples, dicts, lists and tuples), the
same rule at mint and at drain, so the plane conserves by construction.
A device ring counts as the reference's ring of the same geometry: its
six columns, ``prov``, on the PER ring ``priority`` and ``max_priority``,
and ``pos`` and ``fill`` as the reference's int32 scalars (the port's
device copies of them, ``cursor`` and ``fill_rows``, stand in).

Knobs: ``config.BandwidthParams``, each overridable as
``TPU_APEX_WIRE_<FIELD>`` (``TPU_APEX_WIRE=0`` turns the plane off, and
every hook is then one flag check).  ``status_block`` is the gateway's
``T_STATUS`` ``wire`` block.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import weakref
from typing import Any, Dict, Iterable, Optional, Tuple

from pytorch_distributed_tpu_torch.config import BandwidthParams

_ENV_PREFIX = "TPU_APEX_WIRE_"
_OFF = ("0", "false", "off", "no", "")


def resolve_bandwidth(bp: Optional[BandwidthParams] = None
                      ) -> BandwidthParams:
    """``bp`` (or the defaults) with the ``TPU_APEX_WIRE_<FIELD>``
    overrides and the bare ``TPU_APEX_WIRE`` for ``enabled``; a new
    instance, the input is never changed."""
    if bp is None:
        bp = BandwidthParams()
    changes: Dict[str, Any] = {}
    raw_on = os.environ.get("TPU_APEX_WIRE")
    if raw_on is not None:
        changes["enabled"] = raw_on.strip().lower() not in _OFF
    for f in dataclasses.fields(bp):
        raw = os.environ.get(_ENV_PREFIX + f.name.upper())
        if raw is None:
            continue
        cur = getattr(bp, f.name)
        if isinstance(cur, bool):
            changes[f.name] = raw.strip().lower() not in _OFF
        elif isinstance(cur, int):
            changes[f.name] = int(float(raw))
        elif isinstance(cur, float):
            changes[f.name] = float(raw)
        else:
            changes[f.name] = raw.strip()
    return dataclasses.replace(bp, **changes) if changes else bp


def export_env(bp: BandwidthParams) -> None:
    """Export a resolved ``BandwidthParams`` for spawn children;
    ``setdefault``, so an operator's own environment wins."""
    if not bp.enabled:
        os.environ.setdefault("TPU_APEX_WIRE", "0")
    for f in dataclasses.fields(bp):
        val = getattr(bp, f.name)
        if val != f.default:
            os.environ.setdefault(_ENV_PREFIX + f.name.upper(),
                                  ("1" if val is True else
                                   "0" if val is False else str(val)))


# -- sizing --------------------------------------------------------------

# -- frame verbs: parallel/dcn.py registers its frame types at import ----------

_VERB_NAMES: Dict[int, str] = {}


def register_verbs(mapping: Dict[int, str]) -> None:
    _VERB_NAMES.update({int(k): str(v) for k, v in mapping.items()})


def verb_name(ftype: int) -> str:
    return _VERB_NAMES.get(ftype) or f"t{ftype}"


def payload_nbytes(obj, _depth: int = 0) -> int:
    """Array payload bytes of a structured value: ``.nbytes`` summed over
    every array or tensor reachable through NamedTuples, dicts, lists and
    tuples (not the pickle envelope)."""
    if obj is None or _depth > 4:
        return 0
    nb = getattr(obj, "nbytes", None)
    if nb is not None:
        return int(nb)
    if isinstance(obj, (bytes, bytearray)):
        return len(obj)
    if hasattr(obj, "_fields"):              # NamedTuple
        vals: Iterable[Any] = tuple(obj)
    elif isinstance(obj, dict):
        vals = obj.values()
    elif isinstance(obj, (list, tuple)):
        vals = obj
    else:
        return 0
    return sum(payload_nbytes(v, _depth + 1) for v in vals)


def chunk_nbytes(items) -> int:
    """A spawn-queue chunk's bytes (a list of Transitions, or a
    TracedChunk)."""
    return payload_nbytes(items)


# the reference's ring-state fields that hold arrays (ReplayState and
# PerReplayState, memory/device_replay.py:34-48, memory/device_per.py
# :44-56), besides the int32 scalars ``pos`` and ``fill``
_RING_ARRAYS = ("state0", "action", "reward", "gamma_n", "state1",
                "terminal1", "prov", "priority", "max_priority")
_INT32 = 4


def ring_field_nbytes(state) -> Dict[str, int]:
    """Bytes per field of a ring state as the reference's ring of the same
    geometry holds them; a NamedTuple (the reference's own state) counts
    field by field."""
    if hasattr(state, "_fields"):
        return {name: payload_nbytes(v)
                for name, v in zip(state._fields, tuple(state))}
    out = {name: payload_nbytes(getattr(state, name))
           for name in _RING_ARRAYS if getattr(state, name, None) is not None}
    out["pos"] = out["fill"] = _INT32
    return out


def replay_nbytes(state) -> int:
    """The occupancy of a replay state: a ring state (the port's or the
    reference's) by ``ring_field_nbytes``, anything else by
    ``payload_nbytes``."""
    if hasattr(state, "_fields") or dataclasses.is_dataclass(state):
        return sum(ring_field_nbytes(state).values())
    return payload_nbytes(state)


# -- the accountant -----------------------------------------------------------

class LinkAccountant:
    """Cumulative ``(bytes, frames)`` per ``link x verb x slot x
    direction``, gauges, and the rows ingested."""

    def __init__(self, params: Optional[BandwidthParams] = None) -> None:
        self.params = params if params is not None else resolve_bandwidth()
        self._lock = threading.Lock()
        self._counts: Dict[Tuple[str, str, Optional[int], str], list] = {}
        # live socket -> (link, slot), weakly: no socket is pinned
        self._socks: "weakref.WeakKeyDictionary[Any, Tuple[str, Optional[int]]]" \
            = weakref.WeakKeyDictionary()
        self._gauges: Dict[str, float] = {}
        self.transitions = 0       # rows ingested by a gateway
        self.rounds = 0            # replica rounds completed
        self._rate: Dict[str, Tuple[float, int]] = {}  # link -> (t, bytes)

    def register_socket(self, sock, link: str,
                        slot: Optional[int] = None) -> None:
        """Tag a live socket with its link (and its slot once a HELLO
        names it)."""
        try:
            with self._lock:
                self._socks[sock] = (link, slot)
        except TypeError:  # an object that takes no weak reference
            pass

    def link_of(self, sock) -> Tuple[str, Optional[int]]:
        try:
            return self._socks.get(sock) or ("anon", None)
        except TypeError:
            return ("anon", None)

    def note(self, link: str, verb: str, nbytes: int, direction: str,
             slot: Optional[int] = None, frames: int = 1) -> None:
        key = (link, verb, slot, direction)
        with self._lock:
            c = self._counts.get(key)
            if c is None:
                c = self._counts[key] = [0, 0]
            c[0] += int(nbytes)
            c[1] += int(frames)

    def note_frame(self, sock, ftype: int, nbytes: int,
                   direction: str) -> None:
        link, slot = self.link_of(sock)
        self.note(link, verb_name(ftype), nbytes, direction, slot=slot)

    def note_transitions(self, rows: int) -> None:
        with self._lock:
            self.transitions += int(rows)

    def note_round(self) -> None:
        with self._lock:
            self.rounds += 1

    def set_gauge(self, tag: str, value: float) -> None:
        with self._lock:
            self._gauges[str(tag)] = float(value)

    def totals(self, link: Optional[str] = None, verb: Optional[str] = None,
               direction: Optional[str] = None) -> Tuple[int, int]:
        """Cumulative ``(bytes, frames)`` over the keys that match (None:
        any)."""
        b = f = 0
        with self._lock:
            for (lk, vb, _slot, dr), (cb, cf) in self._counts.items():
                if ((link is None or lk == link)
                        and (verb is None or vb == verb)
                        and (direction is None or dr == direction)):
                    b += cb
                    f += cf
        return b, f

    def snapshot(self) -> Dict[str, Any]:
        """``{link: {verb: {direction: [bytes, frames]}}}``, slots
        folded."""
        out: Dict[str, Any] = {}
        with self._lock:
            items = list(self._counts.items())
        for (lk, vb, _slot, dr), (cb, cf) in items:
            d = out.setdefault(lk, {}).setdefault(vb, {})
            cur = d.setdefault(dr, [0, 0])
            cur[0] += cb
            cur[1] += cf
        return out

    def bytes_per_transition(self) -> float:
        """Experience bytes received on the gateway link per row it
        ingested; 0 without a gateway."""
        with self._lock:
            rows = self.transitions
        if rows <= 0:
            return 0.0
        nb, _ = self.totals(link="gateway", verb="exp", direction="rx")
        return nb / rows

    def replica_bytes_per_round(self) -> float:
        """Replica-plane bytes on the gateway link per completed round;
        0 without rounds."""
        with self._lock:
            rounds = self.rounds
        if rounds <= 0:
            return 0.0
        nb = sum(self.totals(link="gateway", verb=v)[0]
                 for v in ("rlease", "rgrad", "rprio"))
        return nb / rounds

    def emit_scalars(self, now: Optional[float] = None) -> Dict[str, float]:
        """The headline series for ``MetricsWriter.scalars``: each link's
        bytes/s since the previous emit (the first emit only primes the
        rates), ``wire/bytes_per_transition`` when a gateway ingested,
        and the gauges."""
        now = time.monotonic() if now is None else now
        out: Dict[str, float] = {}
        per_link: Dict[str, int] = {}
        with self._lock:
            for (lk, _vb, _slot, _dr), (cb, _cf) in self._counts.items():
                per_link[lk] = per_link.get(lk, 0) + cb
            gauges = dict(self._gauges)
        for lk, cum in per_link.items():
            prev = self._rate.get(lk)
            self._rate[lk] = (now, cum)
            if prev is not None:
                dt = now - prev[0]
                if dt >= max(1e-3, float(self.params.rate_floor_s)):
                    out[f"wire/{lk}/bytes_per_s"] = (cum - prev[1]) / dt
        bpt = self.bytes_per_transition()
        if bpt > 0:
            out["wire/bytes_per_transition"] = bpt
        bpr = self.replica_bytes_per_round()
        if bpr > 0:
            out["wire/replica_bytes_per_round"] = bpr
        out.update(gauges)
        return out

    def status_block(self) -> Dict[str, Any]:
        """The ``T_STATUS`` ``wire`` block: per-link totals, the ratios
        and the gauges."""
        per_link: Dict[str, Dict[str, int]] = {}
        with self._lock:
            items = list(self._counts.items())
            transitions = self.transitions
            rounds = self.rounds
            gauges = dict(self._gauges)
        for (lk, _vb, _slot, dr), (cb, cf) in items:
            d = per_link.setdefault(lk, {"bytes": 0, "frames": 0,
                                         "tx_bytes": 0, "rx_bytes": 0})
            d["bytes"] += cb
            d["frames"] += cf
            d["tx_bytes" if dr == "tx" else "rx_bytes"] += cb
        return {
            "links": per_link,
            "transitions": transitions,
            "rounds": rounds,
            "bytes_per_transition": round(self.bytes_per_transition(), 2),
            "replica_bytes_per_round": round(
                self.replica_bytes_per_round(), 2),
            "gauges": gauges,
        }


# -- the process's plane (each spawn child resolves its own) -----------------

_acct_lock = threading.Lock()
_ACCT: Optional[LinkAccountant] = None
_RESOLVED = False


def get_accountant() -> Optional[LinkAccountant]:
    """This process's accountant, or None with the plane off; resolved
    once."""
    global _ACCT, _RESOLVED
    if _RESOLVED:
        return _ACCT
    with _acct_lock:
        if not _RESOLVED:
            params = resolve_bandwidth()
            _ACCT = LinkAccountant(params) if params.enabled else None
            _RESOLVED = True
    return _ACCT


def enabled() -> bool:
    return get_accountant() is not None


def reset_for_tests() -> None:
    """Drop the accountant, so the next hook resolves the environment
    again (tests)."""
    global _ACCT, _RESOLVED
    with _acct_lock:
        _ACCT = None
        _RESOLVED = False


def register_socket(sock, link: str, slot: Optional[int] = None) -> None:
    acct = get_accountant()
    if acct is not None:
        acct.register_socket(sock, link, slot)


def note_frame(sock, ftype: int, nbytes: int, direction: str) -> None:
    acct = get_accountant()
    if acct is not None:
        acct.note_frame(sock, ftype, nbytes, direction)


def note(link: str, verb: str, nbytes: int, direction: str,
         slot: Optional[int] = None, frames: int = 1) -> None:
    acct = get_accountant()
    if acct is not None:
        acct.note(link, verb, nbytes, direction, slot=slot, frames=frames)


def note_spawn(verb: str, items, frames: int = 1) -> None:
    """A spawn-queue boundary: ``mint`` (tx) at the feeder's flush,
    ``drain`` (rx) at the learner's read; off with
    ``BandwidthParams.spawn`` false."""
    acct = get_accountant()
    if acct is not None and acct.params.spawn and frames > 0:
        acct.note("spawn", verb, chunk_nbytes(items),
                  "tx" if verb == "mint" else "rx", frames=frames)


def note_device_replay(*states) -> None:
    """Gauge the attached device ring(s): ``replay/hbm_bytes`` and
    ``replay/hbm_bytes/<field>``, once at attach (the geometry is fixed
    for the run)."""
    acct = get_accountant()
    if acct is None:
        return
    fields: Dict[str, int] = {}
    for st in states:
        if st is None:
            continue
        for name, nb in ring_field_nbytes(st).items():
            fields[name] = fields.get(name, 0) + nb
    acct.set_gauge("replay/hbm_bytes", float(sum(fields.values())))
    for name, nb in fields.items():
        acct.set_gauge(f"replay/hbm_bytes/{name}", float(nb))


_HOST_COLUMNS = ("state0", "action", "reward", "gamma_n", "state1",
                 "terminal1", "prov")


def note_host_replay(mem) -> None:
    """Gauge a host ring's column arrays, ``prov`` included:
    ``replay/host_bytes`` and ``replay/host_bytes/<field>``, once at
    construction.  ``mem.host_columns()`` names them where the ring keeps
    them under other attributes."""
    acct = get_accountant()
    if acct is None:
        return
    cols = (mem.host_columns() if hasattr(mem, "host_columns")
            else {n: getattr(mem, n, None) for n in _HOST_COLUMNS})
    total = 0
    for name in _HOST_COLUMNS:
        nb = payload_nbytes(cols.get(name))
        if nb:
            acct.set_gauge(f"replay/host_bytes/{name}", float(nb))
            total += nb
    acct.set_gauge("replay/host_bytes", float(total))


def note_transitions(rows: int) -> None:
    acct = get_accountant()
    if acct is not None:
        acct.note_transitions(rows)


def note_round() -> None:
    acct = get_accountant()
    if acct is not None:
        acct.note_round()


def set_gauge(tag: str, value: float) -> None:
    acct = get_accountant()
    if acct is not None:
        acct.set_gauge(tag, value)


def emit_scalars() -> Dict[str, float]:
    acct = get_accountant()
    return acct.emit_scalars() if acct is not None else {}


def status_block() -> Optional[Dict[str, Any]]:
    acct = get_accountant()
    return acct.status_block() if acct is not None else None
