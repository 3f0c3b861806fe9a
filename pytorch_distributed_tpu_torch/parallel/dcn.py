"""The DCN wire: remote actors' experience in, parameters out, clocks and
stats both ways — the port of pytorch_distributed_tpu/parallel/dcn.py's
single-gateway part: framing (:139-258), the chunk codec (:264-373),
``parse_endpoints`` (:470-495), the ``T_RGRAD`` and ``T_SSAMPLE`` replies
of a gateway with no replica registry or shard plane (``_pack_round_reply``
:777-809, ``_pack_noshard_reply`` :848-857), ``DcnGateway`` (:1776-2919,
without the HA plane, the replica registry and the shard plane),
``feed_queue_of`` (:2921-2944), ``_sessionless_rpc`` and ``fetch_status``
(:2951-3009), ``redial_backoff`` (:3070-3083), ``DcnDisconnected``,
``DcnRefused``, ``DcnClient`` (:3101-3561) and the actor-side adapters
``RemoteMemory``, ``RemoteParamStore``, ``RemoteClock`` and
``RemoteStats`` (:3564-3689).

The wire is the reference's, byte for byte where the bytes are fixed: a
1-byte frame type and an 8-byte big-endian payload length
(``struct "!BQ"``), then the payload — JSON for control frames
(``json.dumps`` with its default separators), ``np.savez`` for
experience chunks, ``!Q`` version plus raw fp32 for parameters.  A JAX
package client talks to this gateway, and this client to the JAX
package's gateway.  No pickle crosses the wire.

The session layer (failure model of the reference's docstring):

- a send or receive error inside ``DcnClient._request`` redials with
  decorrelated-jitter backoff, re-HELLOs with the incarnation bumped by
  one and resends the one unacknowledged frame: experience delivery is
  at least once; ticks carry a sequence number the gateway deduplicates
  per slot;
- a reconnect that outlives ``DCN_RECONNECT_TIMEOUT`` (30 s), or a frame
  refused ``_MAX_RETRANSMITS`` times across fresh sessions, is terminal:
  ``DcnDisconnected`` and the ``disconnected`` latch, which fleet.py
  turns into ``EXIT_DISCONNECTED``; ``stop`` (set only by a ``T_CLOCK``
  reply's ``stop: true``) means the run is over, exit 0;
- the gateway keys each slot by incarnation: a higher one fences its
  half-open predecessor, an equal or lower one is refused
  (``DcnRefused``), and so is a slot local to the learner's host;
- the client pings (``T_PING``) after ``DCN_HEARTBEAT_INTERVAL`` (10 s)
  idle and bounds each reply by ``DCN_REPLY_DEADLINE`` (180 s); the
  gateway drops a connection idle for ``DCN_IDLE_DEADLINE`` (60 s);
- flow control (utils/flow.py): credits ride the acks, a creditless
  client parks chunks in a drop-oldest ring of ``client_ring`` chunks.

Fault injection (utils/faults.py): ``DCN_FAULTS_CLIENT`` counts the
frames a client sends, ``DCN_FAULTS_GATEWAY`` the session frames a
gateway receives (the sessionless verbs are outside the plane).

Observability: an EXP frame carries its chunk's trace id and birth wall
as savez columns, and the gateway records the wire hop; claims, fences,
releases, reconnects and terminal losses land in the flight recorder
(roles ``gateway`` and ``dcn-client-<slot>``); ``T_STATUS`` answers
``status_snapshot`` to sessionless probes (``fetch_status``).

Every socket here binds or dials what the caller names; tests bind port
0 and read ``DcnGateway.port``.
"""

from __future__ import annotations

import io
import json
import os
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from pytorch_distributed_tpu_torch.agents.param_store import ParamStore
from pytorch_distributed_tpu_torch.memory.feeder import QueueFeeder
from pytorch_distributed_tpu_torch.utils import (
    bandwidth, experience, flight_recorder, flow, health, tracing,
)
from pytorch_distributed_tpu_torch.utils.experience import Transition
from pytorch_distributed_tpu_torch.utils.faults import FaultInjector

# -- framing -------------------------------------------------------------------

_HDR = struct.Struct("!BQ")

T_HELLO = 1    # JSON {role, process_ind, incarnation} -> T_CLOCK
T_EXP = 2      # savez transition chunk              -> T_CLOCK
T_GETP = 3     # !Q min_version                      -> T_PARAMS
T_PARAMS = 4   # !Q version + raw fp32 (version 0: nothing newer)
T_CLOCK = 5    # JSON {learner_step, stop, wall[, credits, brownout]}
T_TICK = 6     # JSON {actor_steps, stats?, seq?, flow?} -> T_CLOCK
T_BYE = 7      # empty                               -> (close)
T_PING = 8     # empty heartbeat                     -> T_CLOCK
T_STATUS = 9   # empty -> T_STATUS JSON snapshot (sessionless)
# the verbs of the planes this gateway is built without; it answers them
# as the reference's gateway answers with no profiler, metrics sink,
# replica registry, HA journal or shard plane
T_PROFILE = 10
T_METRICS = 11
T_RLEASE = 12
T_RGRAD = 13
T_RPRIO = 14
T_SYNC = 15
T_SSAMPLE = 16
T_SMASS = 17
T_SPRIO = 18

# sessionless verbs: outside the wire fault plane
_SESSIONLESS = (T_STATUS, T_PROFILE, T_METRICS, T_RLEASE, T_RGRAD, T_RPRIO,
                T_SYNC, T_SSAMPLE, T_SMASS, T_SPRIO)

_MAX_FRAME = 1 << 31  # rejects garbage lengths

# the reference's full verb table, so the wire X-ray names every verb alike
bandwidth.register_verbs({
    T_HELLO: "hello", T_EXP: "exp", T_GETP: "getp", T_PARAMS: "params",
    T_CLOCK: "clock", T_TICK: "tick", T_BYE: "bye", T_PING: "ping",
    T_STATUS: "status", T_PROFILE: "profile", T_METRICS: "metrics",
    T_RLEASE: "rlease", T_RGRAD: "rgrad", T_RPRIO: "rprio",
    T_SYNC: "sync", T_SSAMPLE: "ssample", T_SMASS: "smass",
    T_SPRIO: "sprio",
})

# T_RGRAD's status with no replica registry wired
RSTAT_NOREG = 4


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _send_frame(sock: socket.socket, ftype: int, payload: bytes) -> None:
    # counted before the send, so a reader after a round trip never sees
    # the reply counted and the request not
    bandwidth.note_frame(sock, ftype, _HDR.size + len(payload), "tx")
    sock.sendall(_HDR.pack(ftype, len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            raise ConnectionError("peer closed")
        buf.extend(part)
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> Tuple[int, bytes]:
    ftype, length = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if length > _MAX_FRAME:
        raise ConnectionError(f"oversized frame: {length}")
    payload = _recv_exact(sock, length) if length else b""
    bandwidth.note_frame(sock, ftype, _HDR.size + length, "rx")
    return ftype, payload


# -- the experience chunk codec: columnar savez ----------------------------------

_FIELDS = experience.REPLAY_FIELDS

# every column encode_chunk may write and decode_chunk may read
WIRE_COLUMNS = experience.REPLAY_FIELDS + (
    "priority", "priority_ok", "prov", "trace_id", "trace_born")


def encode_chunk(items: List[Tuple[Transition, Optional[float]]]) -> bytes:
    """``[(transition, priority or None), ...]`` as one savez payload.  A
    None priority travels as ``priority_ok`` False (a NaN priority stays
    a NaN, for the gateway's quarantine); ``prov`` ships only when a row
    carries provenance; a ``TracedChunk`` adds its trace id and birth."""
    cols = {f: np.stack([np.asarray(getattr(t, f)) for t, _ in items])
            for f in _FIELDS}
    cols["priority"] = np.array(
        [np.nan if p is None else float(p) for _, p in items],
        dtype=np.float32)
    cols["priority_ok"] = np.array([p is not None for _, p in items],
                                   dtype=np.bool_)
    prov = experience.stack_prov(items)
    if (prov >= 0).any():
        cols["prov"] = prov
    if isinstance(items, tracing.TracedChunk):
        cols["trace_id"] = np.array([items.trace_id], dtype=np.uint64)
        cols["trace_born"] = np.array([items.born], dtype=np.float64)
    out = io.BytesIO()
    np.savez(out, **cols)
    return out.getvalue()


def decode_chunk(payload: bytes
                 ) -> List[Tuple[Transition, Optional[float]]]:
    """Decode and check one EXP payload.  A well-framed chunk with
    missing, short or non-numeric columns raises ``ValueError`` (the
    gateway counts it and acks: a resend cannot help); bytes ``np.load``
    cannot read raise ``ConnectionError`` (the connection drops and the
    client's resend carries a clean copy)."""
    try:
        with np.load(io.BytesIO(payload)) as z:
            cols = {k: z[k] for k in z.files}
    except Exception as e:
        raise ConnectionError(f"unparseable EXP payload: {e!r}")
    missing = [f for f in _FIELDS + ("priority",) if f not in cols]
    if missing:
        raise ValueError(f"malformed chunk: missing columns {missing}")
    pr = cols["priority"]
    if pr.ndim != 1 or pr.dtype.kind != "f":
        raise ValueError(
            f"malformed chunk: priority must be a 1-D float column "
            f"(got ndim={pr.ndim}, dtype={pr.dtype})")
    n = len(pr)
    for f in _FIELDS:
        c = cols[f]
        if c.ndim < 1 or len(c) != n:
            raise ValueError(
                f"malformed chunk: column {f} is "
                f"{'scalar' if c.ndim < 1 else f'length {len(c)}'}, "
                f"want length {n}")
        if c.dtype.kind not in "fiub":
            raise ValueError(
                f"malformed chunk: column {f} dtype {c.dtype} "
                f"is not numeric")
    ok = cols.get("priority_ok")
    if ok is not None and (ok.ndim != 1 or len(ok) != n):
        raise ValueError("malformed chunk: priority_ok length mismatch")
    pv = cols.get("prov")
    if pv is not None and (pv.ndim != 2 or len(pv) != n
                           or pv.shape[1] != len(experience.PROV_FIELDS)
                           or pv.dtype.kind not in "iu"):
        raise ValueError("malformed chunk: prov column must be "
                         f"(n, {len(experience.PROV_FIELDS)}) integer "
                         f"(got shape {pv.shape}, dtype {pv.dtype})")
    items: List[Tuple[Transition, Optional[float]]] = []
    for i in range(n):
        t = Transition(*(cols[f][i] for f in _FIELDS))
        if pv is not None and pv[i][0] >= 0:
            t = t._replace(prov=np.asarray(pv[i], experience.PROV_DTYPE))
        p = pr[i]
        valid = bool(ok[i]) if ok is not None else not np.isnan(p)
        items.append((t, float(p) if valid else None))
    if "trace_id" in cols:  # the trace goes on past the wire
        return tracing.TracedChunk(items,
                                   trace_id=int(cols["trace_id"][0]),
                                   born=float(cols["trace_born"][0]))
    return items


def _pack_round_reply(status: int) -> bytes:
    """A ``T_RGRAD`` reply with no gradient, no members and no
    write-backs: what a gateway with no replica registry answers."""
    cols = {
        "status": np.asarray([status], np.int64),
        "generation": np.asarray([0], np.int64),
        "round": np.asarray([0], np.int64),
        "members": np.asarray([], np.int64),
        "applied": np.asarray([0], np.int64),
        "epoch_due": np.asarray([0], np.int64),
    }
    out = io.BytesIO()
    np.savez(out, **cols)
    return out.getvalue()


def _pack_noshard_reply() -> bytes:
    """The ``T_SSAMPLE`` reply of a gateway with no shard plane (status 3,
    the reference's ``SSTAT_NOSHARD``)."""
    out = io.BytesIO()
    np.savez(out, status=np.asarray([3], np.int64),
             generation=np.asarray([0], np.int64))
    return out.getvalue()


def parse_endpoints(spec) -> List[Tuple[str, int]]:
    """``host:port,host:port`` (or an address, or a list of either) as an
    ordered endpoint list for the client's dialing."""
    if not spec:
        return []
    if isinstance(spec, (list, tuple)):
        if (len(spec) == 2 and isinstance(spec[0], str)
                and isinstance(spec[1], int)):
            return [(spec[0], int(spec[1]))]  # one ("host", port)
        out: List[Tuple[str, int]] = []
        for item in spec:
            if isinstance(item, str):
                out.extend(parse_endpoints(item))
            else:
                h, p = item
                out.append((h, int(p)))
        return out
    out = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        out.append((host or "127.0.0.1", int(port)))
    return out


# -- the gateway -----------------------------------------------------------------

class DcnGateway:
    """Accepts remote actors' connections on the learner's host, one serve
    thread each.  ``put_chunk`` takes each decoded ``[(Transition,
    priority), ...]`` chunk (``feed_queue_of`` wires it to the learner's
    ingest).  Each remote slot maps to the ``(incarnation, connection)``
    that holds it; a connection idle past ``idle_deadline`` is dropped
    and frees its slot.  With the flow plane on, ``pressure`` (0..1)
    drives the overload governor whose credits ride every ack."""

    def __init__(self, param_store, clock, actor_stats,
                 put_chunk: Callable[[list], None],
                 host: str = "0.0.0.0", port: int = 0,
                 local_actors: int = 0,
                 idle_deadline: Optional[float] = None,
                 faults: Optional[FaultInjector] = None,
                 health: Optional[Callable[[], dict]] = None,
                 flow_params=None,
                 pressure: Optional[Callable[[], float]] = None,
                 flow_writer=None):
        self.param_store = param_store
        self.clock = clock
        self.actor_stats = actor_stats
        self.put_chunk = put_chunk
        self.local_actors = local_actors
        self._idle_deadline = (_env_float("DCN_IDLE_DEADLINE", 60.0)
                               if idle_deadline is None else idle_deadline)
        self._faults = (faults if faults is not None
                        else FaultInjector.from_env("gateway"))
        # the owning topology's extra STATUS fields, read per request
        self._health = health
        self.profiles_served = 0
        self.metrics_batches = 0
        self.metrics_rows = 0
        self.sync_served = 0
        self._tracer = tracing.get_tracer("gateway")
        self._recorder = flight_recorder.get_recorder("gateway")
        self._flow = None
        if flow.resolve_flow(flow_params).enabled:
            self._flow = flow.GatewayFlow(
                flow_params, pressure=pressure,
                recorder=self._recorder, writer=flow_writer)
        self._born = time.monotonic()
        self._srv = socket.create_server((host, port))
        self._srv.settimeout(0.25)
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._slots: Dict[int, Tuple[int, socket.socket]] = {}
        self._tick_seq: Dict[int, int] = {}  # per-slot dedup high-water
        self._last_seen: Dict[int, float] = {}  # slot -> last frame
        self._slots_lock = threading.Lock()
        self._conns: Set[socket.socket] = set()
        self.connections = 0
        self.chunks_in = 0
        self.status_served = 0
        self.fenced = 0  # predecessors evicted by higher incarnations
        self.frames_rejected = 0  # schema-invalid EXP frames, acked
        self.quarantined: Dict[str, int] = {}  # per source slot
        self._validators: Dict[str, Any] = {}
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="dcn-accept", daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, addr = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # the slot is known at HELLO, when the serve loop re-tags it
            bandwidth.register_socket(conn, "gateway")
            self.connections += 1
            with self._slots_lock:
                self._conns.add(conn)
            t = threading.Thread(target=self._serve, args=(conn, addr),
                                 name=f"dcn-conn-{addr}", daemon=True)
            t.start()
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _clock_payload(self, slot: Optional[int] = None) -> bytes:
        msg = {
            "learner_step": int(self.clock.learner_step.value),
            "stop": bool(self.clock.stop.is_set()),
            # the gateway's wall clock, for the client's offset estimate
            "wall": time.time(),
        }
        if self._flow is not None and slot is not None:
            grant = self._flow.grant(slot)
            if grant is not None:
                msg["credits"] = grant
            tier = self._flow.governor.tier
            if tier:
                msg["brownout"] = tier
        return json.dumps(msg).encode()

    @property
    def flow(self):
        """The gateway's ``GatewayFlow`` (None with the plane off)."""
        return self._flow

    @property
    def faults_injected(self) -> int:
        """Wire faults fired on this gateway's frames."""
        return self._faults.injected

    @property
    def active_slots(self) -> Dict[int, int]:
        """``{slot: incarnation}``."""
        with self._slots_lock:
            return {s: inc for s, (inc, _c) in self._slots.items()}

    def status_snapshot(self) -> dict:
        """Slots with incarnations and heartbeat ages, the clocks, the
        gateway's counters, the ``flow`` and ``wire`` blocks, and what
        the owning topology's ``health`` provider adds."""
        now = time.monotonic()
        with self._slots_lock:
            slots = {
                str(s): {
                    "incarnation": inc,
                    "heartbeat_age": round(
                        now - self._last_seen.get(s, now), 3),
                }
                for s, (inc, _c) in self._slots.items()
            }
        snap = {
            "wall": time.time(),
            "uptime": round(now - self._born, 3),
            "learner_step": int(self.clock.learner_step.value),
            "actor_step": int(self.clock.actor_step.value),
            "stop": bool(self.clock.stop.is_set()),
            "local_actors": self.local_actors,
            "slots": slots,
            "connections": self.connections,
            "chunks_in": self.chunks_in,
            "fenced": self.fenced,
            "metrics_batches": self.metrics_batches,
            "metrics_rows": self.metrics_rows,
            "frames_rejected": self.frames_rejected,
            "quarantined": dict(self.quarantined),
        }
        if self._flow is not None:
            snap["flow"] = self._flow.status_block(
                quarantined=sum(snap["quarantined"].values()))
        wire_blk = bandwidth.status_block()
        if wire_blk is not None:
            if self._flow is not None:
                cons = snap.get("flow", {}).get("conservation", {})
                wire_blk["ledger"] = {
                    k: cons[k] for k in (
                        "acked_bytes", "ingested_bytes",
                        "rejected_bytes", "shed_bytes",
                        "accounted_bytes", "bytes_balanced")
                    if k in cons}
            snap["wire"] = wire_blk
        if self._health is not None:
            try:
                snap.update(self._health() or {})
            except Exception as e:  # noqa: BLE001 - the extras are best-effort
                snap["health_error"] = repr(e)
        return snap

    def _claim_slot(self, ind: Optional[int], incarnation: int,
                    conn: socket.socket) -> Optional[str]:
        """Register a remote actor's slot; an error string on a conflict.
        A slot held by a lower incarnation is this actor's own half-open
        predecessor: its connection is shut and the slot re-keyed.  An
        equal or higher one is a live duplicate, refused; so is a slot
        local to the learner's host."""
        if ind is None:
            return None
        evict: Optional[socket.socket] = None
        with self._slots_lock:
            if ind < self.local_actors:
                return (f"actor slot {ind} is local to the learner host "
                        f"(local_actors={self.local_actors})")
            held = self._slots.get(ind)
            if held is not None:
                held_inc, held_conn = held
                if incarnation <= held_inc:
                    return (f"actor slot {ind} already connected "
                            f"(incarnation {incarnation} <= {held_inc})")
                evict = held_conn
                self.fenced += 1
                self._recorder.record("fence", slot=ind,
                                      old=held_inc, new=incarnation)
            self._slots[ind] = (incarnation, conn)
            self._last_seen[ind] = time.monotonic()
        if evict is not None:
            # outside the lock; its release is identity-checked, so it
            # cannot free this claim
            try:
                evict.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._recorder.record("slot-claimed", slot=ind,
                              incarnation=incarnation)
        return None

    def _quarantine(self, slot: Optional[int], items: list) -> list:
        """The ingest quarantine on the wire: rows a per-slot
        ``ChunkValidator`` rejects go to the ``gateway-slot<i>`` store
        and the slot's count; returns the clean rest."""
        if not items or not health.quarantine_active():
            return items
        src = f"slot{slot}" if slot is not None else "anon"
        validator = self._validators.get(src)
        if validator is None:
            validator = self._validators[src] = health.ChunkValidator()
        good, bad = validator.filter(items)
        if bad:
            with self._slots_lock:
                self.quarantined[src] = (self.quarantined.get(src, 0)
                                         + len(bad))
            self._recorder.record("chunk-quarantined", slot=slot,
                                  n=len(bad), reason=bad[0][2])
            health.get_quarantine(f"gateway-{src}").put(
                bad, trace_id=getattr(items, "trace_id", 0))
            if isinstance(items, tracing.TracedChunk):
                good = tracing.TracedChunk(good, trace_id=items.trace_id,
                                           born=items.born)
        return good

    def _fresh_tick(self, slot: Optional[int], seq: Optional[int]) -> bool:
        """False for a retransmitted tick (seq at or below the slot's
        high-water).  The map outlives releases and fences; a gateway
        restart forgets it."""
        if slot is None or seq is None:
            return True
        with self._slots_lock:
            if seq <= self._tick_seq.get(slot, -1):
                return False
            self._tick_seq[slot] = seq
            return True

    def _release_slot(self, slot: Optional[int],
                      conn: socket.socket) -> None:
        with self._slots_lock:
            self._conns.discard(conn)
            if slot is None:
                return
            held = self._slots.get(slot)
            if held is not None and held[1] is conn:
                del self._slots[slot]
                self._recorder.record("slot-released", slot=slot,
                                      incarnation=held[0])

    def _reply_unwired(self, conn: socket.socket, ftype: int,
                       payload: bytes) -> None:
        """The sessionless verbs of the planes this gateway does not
        carry, answered as the reference's gateway answers them when
        built without them."""
        if ftype == T_STATUS:
            self.status_served += 1
            _send_frame(conn, T_STATUS,
                        json.dumps(self.status_snapshot()).encode())
        elif ftype == T_PROFILE:
            msg = self._json(payload) if payload else {}
            self.profiles_served += 1
            self._recorder.record("profile-served", ok=False,
                                  seconds=msg.get("seconds"))
            _send_frame(conn, T_PROFILE, json.dumps(
                {"error": "no profiler wired on this gateway"}).encode())
        elif ftype == T_METRICS:
            if payload:
                self._json(payload)
            reply: Dict[str, Any] = {
                "accepted": 0,
                "error": "no metrics sink wired on this gateway"}
            self.metrics_batches += 1
            reply["wall"] = time.time()
            if self._flow is not None and self._flow.governor.tier >= 1:
                reply["brownout"] = self._flow.governor.tier
            _send_frame(conn, T_METRICS, json.dumps(reply).encode())
        elif ftype in (T_RLEASE, T_RPRIO):
            if ftype == T_RLEASE and payload:
                self._json(payload)
            _send_frame(conn, ftype, json.dumps(
                {"status": "error",
                 "error": "no replica registry wired on this gateway"}
            ).encode())
        elif ftype == T_RGRAD:
            _send_frame(conn, T_RGRAD, _pack_round_reply(RSTAT_NOREG))
        elif ftype == T_SSAMPLE:
            _send_frame(conn, T_SSAMPLE, _pack_noshard_reply())
        elif ftype in (T_SMASS, T_SPRIO):
            if ftype == T_SMASS and payload:
                self._json(payload)
            _send_frame(conn, ftype, json.dumps(
                {"status": "error",
                 "error": "no shard plane wired on this gateway"}
            ).encode())
        elif ftype == T_SYNC:
            if payload:
                self._json(payload)
            self.sync_served += 1
            _send_frame(conn, T_SYNC, json.dumps(
                {"error": "no HA journal serving on this gateway"}
            ).encode())

    def _serve_exp(self, conn: socket.socket, slot: Optional[int],
                   payload: bytes) -> None:
        # every acked EXP payload's bytes land in one bucket: rejected,
        # shed or ingested (the quarantine refines rows, not bytes)
        nbytes = len(payload)
        try:
            items = decode_chunk(payload)
        except ConnectionError:
            raise
        except ValueError as e:
            # a malformed peer: a resend of the same bytes cannot help, so
            # count, ack and drop the frame; the session lives on
            self.frames_rejected += 1
            if self._flow is not None:
                self._flow.note_rejected_bytes(nbytes)
            self._recorder.record("frame-rejected", slot=slot,
                                  error=str(e)[:200])
            if self.frames_rejected <= 3:
                print(f"[dcn] rejected malformed EXP frame from slot "
                      f"{slot}: {e}", flush=True)
            _send_frame(conn, T_CLOCK, self._clock_payload(slot))
            return
        except Exception as e:
            raise ConnectionError(f"undecodable EXP frame: {e!r}")
        if isinstance(items, tracing.TracedChunk) and not (
                self._flow is not None and self._flow.governor.tier >= 2):
            # the actor's flush to this receipt: the wire hop
            self._tracer.record_hop("gateway", items.born, items.trace_id)
        admitted = (self._flow is None
                    or self._flow.admit(slot, len(items), nbytes=nbytes))
        if admitted:
            if self._flow is not None:
                self._flow.note_ingested_bytes(nbytes)
            items = self._quarantine(slot, items)
        else:
            # the one gateway shed point (tier 3, bucket dry): acked, so
            # the peer does not resend what is being shed
            items = []
        if items:
            bandwidth.note_transitions(len(items))
            if self._flow is not None:
                self._flow.note_ingested(len(items))
            try:
                self.put_chunk(items)
            except ValueError:
                # the ingest is closed: the run is over, and the ack
                # carries the stop
                pass
        self.chunks_in += 1
        _send_frame(conn, T_CLOCK, self._clock_payload(slot))

    def _serve(self, conn: socket.socket, addr) -> None:
        slot: Optional[int] = None
        if self._idle_deadline and self._idle_deadline > 0:
            conn.settimeout(self._idle_deadline)
        try:
            with conn:
                while not self._stop.is_set():
                    ftype, payload = _recv_frame(conn)
                    if ftype not in _SESSIONLESS:
                        # a probe must not shift a drill's frame schedule
                        payload = self._faults.frame(payload)
                    if slot is not None:
                        self._last_seen[slot] = time.monotonic()
                    if ftype == T_BYE:
                        return
                    if ftype in _SESSIONLESS:
                        self._reply_unwired(conn, ftype, payload)
                    elif ftype == T_EXP:
                        self._serve_exp(conn, slot, payload)
                    elif ftype == T_GETP:
                        try:
                            (min_version,) = struct.unpack("!Q", payload)
                        except struct.error as e:
                            raise ConnectionError(
                                f"undecodable GETP frame: {e}")
                        got = self.param_store.fetch(min_version)
                        if got is None:
                            _send_frame(conn, T_PARAMS,
                                        struct.pack("!Q", 0))
                        else:
                            flat, version = got
                            _send_frame(
                                conn, T_PARAMS,
                                struct.pack("!Q", version)
                                + np.ascontiguousarray(
                                    flat, dtype=np.float32).tobytes())
                    elif ftype == T_PING:
                        # the ack carries the slot's fresh grant
                        _send_frame(conn, T_CLOCK, self._clock_payload(slot))
                    elif ftype == T_TICK:
                        msg = self._json(payload)
                        try:
                            steps = int(msg.get("actor_steps", 0))
                            seq = msg.get("seq")
                            seq = int(seq) if seq is not None else None
                            kv = {k: float(v) for k, v
                                  in (msg.get("stats") or {}).items()}
                        except (TypeError, ValueError) as e:
                            raise ConnectionError(
                                f"undecodable TICK frame: {e}")
                        if self._fresh_tick(slot, seq):
                            if steps:
                                self.clock.add_actor_steps(steps)
                            if kv:
                                self.actor_stats.add(**kv)
                        if self._flow is not None:
                            # cumulative counters: idempotent outside the
                            # dedup gate
                            self._flow.on_client_report(
                                slot, msg.get("flow"))
                        _send_frame(conn, T_CLOCK, self._clock_payload(slot))
                    elif ftype == T_HELLO:
                        msg = self._json(payload)
                        try:
                            ind = msg.get("process_ind")
                            ind = int(ind) if ind is not None else None
                            inc = int(msg.get("incarnation", 0))
                        except (TypeError, ValueError) as e:
                            raise ConnectionError(
                                f"undecodable HELLO frame: {e}")
                        err = self._claim_slot(ind, inc, conn)
                        if err is not None:
                            reply = json.loads(self._clock_payload())
                            reply["error"] = err
                            _send_frame(conn, T_CLOCK,
                                        json.dumps(reply).encode())
                            return
                        slot = ind
                        bandwidth.register_socket(conn, "gateway", slot)
                        _send_frame(conn, T_CLOCK, self._clock_payload(slot))
                    else:
                        raise ConnectionError(f"bad frame type {ftype}")
        except (ConnectionError, OSError):
            return  # the peer went away or idled out
        finally:
            self._release_slot(slot, conn)

    @staticmethod
    def _json(payload: bytes) -> dict:
        try:
            return json.loads(payload.decode())
        except (ValueError, UnicodeDecodeError) as e:
            raise ConnectionError(f"undecodable control frame: {e}")

    def close(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        # the port is free once the accept thread left accept(): join it,
        # or a rebind on the same port (restart_gateway) races
        self._accept_thread.join(2.0)
        with self._slots_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for t in self._threads:
            t.join(1.0)


def _bare(items: list) -> list:
    """``[(Transition, priority)]`` as the Transitions the ingest queues
    carry, the trace kept."""
    rows = [t for t, _p in items]
    if isinstance(items, tracing.TracedChunk):
        return tracing.TracedChunk(rows, trace_id=items.trace_id,
                                   born=items.born)
    return rows


def feed_queue_of(memory_handles) -> Callable[[list], None]:
    """The gateway's ``put_chunk``: a queue-fed ingest (``SlotQueues``:
    the device rings, ``QueueOwner``) takes the chunk on its in-process
    remote queue, looked up at each put; a ring every process writes in
    place (``SharedReplay``, ``NativeRingReplay``) is fed directly."""
    learner_side = memory_handles.learner_side
    if hasattr(learner_side, "put_remote"):
        def _enqueue(items: list) -> None:
            learner_side.put_remote(_bare(items))
        return _enqueue

    def _direct(items: list) -> None:
        if isinstance(items, tracing.TracedChunk):
            # fed on the serve thread: the feed hop is this receipt
            tracing.get_tracer("feeder").record_hop(
                "feed", items.born, items.trace_id)
        for t, p in items:
            learner_side.feed(t, p)
    return _direct


# -- sessionless probes ------------------------------------------------------------

def _sessionless_rpc(address: Tuple[str, int], ftype: int, payload: bytes,
                     timeout: float, what: str,
                     retry_after_send: bool = True) -> dict:
    """One bounded round trip on a fresh connection, retried once on a
    fresh one (``retry_after_send`` False: only a failed connect)."""
    last: Optional[BaseException] = None
    for attempt in (0, 1):
        try:
            sock = socket.create_connection(address, timeout=timeout)
            bandwidth.register_socket(sock, "probe")
        except OSError as e:
            last = e
            if attempt == 0:
                time.sleep(min(0.2, timeout / 10.0))
            continue
        sent = False
        try:
            sock.settimeout(timeout)
            _send_frame(sock, ftype, payload)
            sent = True
            rtype, reply = _recv_frame(sock)
            if rtype != ftype:
                raise ConnectionError(
                    f"expected {what} reply, got frame type {rtype}")
            try:
                return json.loads(reply.decode())
            except (ValueError, UnicodeDecodeError) as e:
                raise ConnectionError(f"undecodable {what} reply: {e}")
        except (ConnectionError, OSError) as e:
            last = e
            if attempt == 1 or (sent and not retry_after_send):
                raise
            time.sleep(min(0.2, timeout / 10.0))
        finally:
            try:
                sock.close()
            except OSError:
                pass
    raise ConnectionError(f"{what} request to {address} failed: {last!r}")


def fetch_status(address: Tuple[str, int], timeout: float = 5.0) -> dict:
    """One ``T_STATUS`` round trip: the gateway's ``status_snapshot``.  No
    HELLO and no slot; raises ``ConnectionError`` or ``OSError`` when the
    gateway stays unreachable."""
    return _sessionless_rpc(address, T_STATUS, b"", timeout, "T_STATUS")


# -- the actor host's client ---------------------------------------------------------

def redial_backoff(rng, prev: float, cap: float = 1.0,
                   base: float = 0.05) -> float:
    """Decorrelated jitter: uniform in ``[base, prev * 3]``, capped, drawn
    from the client's own stream (seeded by its slot)."""
    hi = max(prev * 3.0, base * 1.001)
    return float(min(cap, rng.uniform(base, hi)))


class DcnDisconnected(ConnectionError):
    """Terminal session loss: the reconnect budget is spent, or the
    client is closing."""


class DcnRefused(RuntimeError):
    """The gateway refused the HELLO (a slot conflict, a local slot)."""


class DcnClient:
    """One connection to the gateway, shared by one actor process's
    adapters: synchronous request and reply under a lock, every reply
    refreshing the cached learner step.  A failure mid-RPC redials,
    re-HELLOs with a bumped incarnation and resends the unacked frame;
    a terminal loss raises ``DcnDisconnected`` and latches
    ``disconnected``.  ``stop`` means the learner ended the run.  A
    heartbeat thread pings after ``heartbeat_interval`` idle seconds."""

    def __init__(self, address, process_ind: int = 0,
                 connect_timeout: float = 60.0, retries: int = 20,
                 incarnation: Optional[int] = None,
                 heartbeat_interval: Optional[float] = None,
                 reply_deadline: Optional[float] = None,
                 reconnect_timeout: Optional[float] = None,
                 faults: Optional[FaultInjector] = None):
        # an ordered endpoint list; a failed dial cycles to the next
        self.endpoints = parse_endpoints(address) or [address]
        self._ep = 0
        self.failovers = 0
        self.address = self.endpoints[0]
        self.process_ind = process_ind
        self._lock = threading.RLock()
        self.learner_step = 0
        self.stop = threading.Event()          # the learner said stop
        self.disconnected = threading.Event()  # the session is lost
        # a wall-clock base: a replacement process still fences the slot
        # its predecessor left half-open; each reconnect adds one
        self.incarnation = (int(incarnation) if incarnation is not None
                            else time.time_ns() // 1_000_000)
        # the tick dedup sequence, on the same base
        self._tick_seq = time.time_ns() // 1_000_000
        self.reconnects = 0
        self._flow_params = flow.resolve_flow()
        # the latest grant; None: no credit field (unlimited)
        self.credits: Optional[int] = None
        self.flow_ring = flow.DropOldestRing(
            self._flow_params.client_ring, owner=process_ind)
        self.flow_minted_rows = 0   # rows offered to send_chunk
        self.flow_acked_rows = 0    # rows the wire acknowledged
        self.flow_acked_bytes = 0   # EXP payload bytes acknowledged
        self._flow_blocked_logged = False
        # seconds to add to this host's time.time() for the gateway's
        # clock, from the acks' ``wall`` against the RPC midpoint
        self.clock_offset: Optional[float] = None
        self._offset_logged: Optional[float] = None
        self._closed = False
        self._faults = (faults if faults is not None
                        else FaultInjector.from_env("client"))
        self._heartbeat_interval = (
            _env_float("DCN_HEARTBEAT_INTERVAL", 10.0)
            if heartbeat_interval is None else heartbeat_interval)
        self._reply_deadline = (
            _env_float("DCN_REPLY_DEADLINE", 180.0)
            if reply_deadline is None else reply_deadline)
        self._reconnect_timeout = (
            _env_float("DCN_RECONNECT_TIMEOUT", 30.0)
            if reconnect_timeout is None else reconnect_timeout)
        self._recorder = flight_recorder.get_recorder(
            f"dcn-client-{process_ind}")
        self._redial_rng = np.random.default_rng((0xDC2, process_ind))
        self._last_rpc = time.monotonic()
        deadline = time.monotonic() + connect_timeout
        delay = 0.1
        while True:
            try:
                self.address = self.endpoints[self._ep]
                self._sock = socket.create_connection(self.address,
                                                      timeout=30.0)
                bandwidth.register_socket(self._sock, "client",
                                          process_ind)
                break
            except OSError:
                if time.monotonic() > deadline or retries <= 0:
                    raise
                retries -= 1
                self._ep = (self._ep + 1) % len(self.endpoints)
                time.sleep(delay)
                delay = min(delay * 2, 2.0)
        self._configure(self._sock)
        self._request(T_HELLO, self._hello_payload())
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        if self._heartbeat_interval and self._heartbeat_interval > 0:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop,
                name=f"dcn-heartbeat-{process_ind}", daemon=True)
            self._hb_thread.start()

    def _configure(self, sock: socket.socket) -> None:
        # a bounded reply wait: a frozen peer enters the reconnect path
        sock.settimeout(self._reply_deadline
                        if self._reply_deadline and self._reply_deadline > 0
                        else None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def _hello_payload(self) -> bytes:
        return json.dumps({"role": "actor",
                           "process_ind": self.process_ind,
                           "incarnation": self.incarnation}).encode()

    def _handle_reply(self, rtype: int, rpayload: bytes,
                      rpc_mid: Optional[float] = None) -> None:
        if rtype != T_CLOCK:
            return
        msg = json.loads(rpayload.decode())
        if rpc_mid is not None and "wall" in msg:
            sample = float(msg["wall"]) - rpc_mid
            self.clock_offset = (sample if self.clock_offset is None
                                 else 0.9 * self.clock_offset
                                 + 0.1 * sample)
            if (self._offset_logged is None
                    or abs(self.clock_offset
                           - self._offset_logged) > 0.05):
                self._offset_logged = self.clock_offset
                self._recorder.record(
                    "clock_sync", offset=round(self.clock_offset, 6),
                    slot=self.process_ind)
        self.learner_step = int(msg["learner_step"])
        if self._flow_params.enabled:
            c = msg.get("credits")
            self.credits = int(c) if c is not None else None
            tier = int(msg.get("brownout", 0) or 0)
            if tier != flow.brownout_tier():
                flow.set_brownout(tier)
                self._recorder.record("brownout", tier=tier,
                                      slot=self.process_ind)
        if msg.get("stop"):
            self.stop.set()
        if "error" in msg:  # e.g. a slot conflict at HELLO
            self.disconnected.set()
            raise DcnRefused(f"gateway refused: {msg['error']}")

    def _terminal(self, why: str) -> DcnDisconnected:
        # a close() is not a loss: a heartbeat racing a clean shutdown
        # must not turn a finished run into EXIT_DISCONNECTED
        if not self._closed:
            self.disconnected.set()
            self._recorder.record("dcn-terminal", slot=self.process_ind,
                                  why=why, reconnects=self.reconnects)
            flight_recorder.dump_all(
                f"DcnDisconnected slot {self.process_ind}: {why}")
        return DcnDisconnected(
            f"DCN session to {self.address} lost (slot "
            f"{self.process_ind}): {why}")

    def _reconnect(self) -> Tuple[int, bytes]:
        """Redial and re-HELLO under the request lock; the HELLO's reply,
        or ``DcnDisconnected`` once the budget is spent (or the client
        closes, or the run is over)."""
        try:
            self._sock.close()
        except OSError:
            pass
        deadline = time.monotonic() + self._reconnect_timeout
        delay = 0.05
        while True:
            if self._closed:
                raise self._terminal("client closed")
            if self.stop.is_set():
                raise self._terminal("stop already set")
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise self._terminal(
                    f"reconnect budget ({self._reconnect_timeout:.1f}s) "
                    f"exhausted")
            addr = self.endpoints[self._ep]
            try:
                sock = socket.create_connection(
                    addr, timeout=max(0.1, min(5.0, remaining)))
            except OSError:
                self._ep = (self._ep + 1) % len(self.endpoints)
                time.sleep(min(delay, max(0.0, remaining)))
                delay = redial_backoff(self._redial_rng, delay)
                continue
            # the HELLO is bounded by the reconnect budget, not the reply
            # deadline
            sock.settimeout(max(0.1, min(self._reply_deadline, remaining)
                                if self._reply_deadline
                                and self._reply_deadline > 0
                                else remaining))
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            bandwidth.register_socket(sock, "client", self.process_ind)
            self.incarnation += 1
            try:
                _send_frame(sock, T_HELLO, self._hello_payload())
                rtype, rpayload = _recv_frame(sock)
            except (ConnectionError, OSError):
                try:
                    sock.close()
                except OSError:
                    pass
                self._ep = (self._ep + 1) % len(self.endpoints)
                time.sleep(min(delay, max(0.0, remaining)))
                delay = redial_backoff(self._redial_rng, delay)
                continue
            self._configure(sock)
            self._sock = sock
            self.reconnects += 1
            if addr != self.address:
                self.failovers += 1
                self._recorder.record("failover", slot=self.process_ind,
                                      frm=list(self.address),
                                      to=list(addr))
                self.address = addr
            self._recorder.record("reconnect", slot=self.process_ind,
                                  incarnation=self.incarnation,
                                  count=self.reconnects)
            try:
                self._handle_reply(rtype, rpayload)
            except DcnRefused as e:
                # the slot is held at or above this incarnation
                raise self._terminal(str(e)) from e
            return rtype, rpayload

    # refused resends of one frame across fresh sessions before it is
    # poison; reply timeouts never count (backpressure stalls the actor)
    _MAX_RETRANSMITS = 5

    def _request(self, ftype: int, payload: bytes) -> Tuple[int, bytes]:
        with self._lock:
            if self.disconnected.is_set() or self._closed:
                raise self._terminal("session already closed")
            retransmits = 0
            rpc_mid = None
            while True:
                try:
                    wire = self._faults.frame(payload)
                    t_send = time.time()
                    _send_frame(self._sock, ftype, wire)
                    rtype, rpayload = _recv_frame(self._sock)
                    rpc_mid = (t_send + time.time()) / 2.0
                    break
                except (ConnectionError, OSError) as e:
                    timed_out = isinstance(e, socket.timeout)
                    if (not timed_out
                            and retransmits >= self._MAX_RETRANSMITS):
                        raise self._terminal(
                            f"frame type {ftype} refused "
                            f"{retransmits}x across fresh sessions "
                            f"(poison frame?)")
                    reply = self._reconnect()
                    if ftype == T_HELLO:
                        # the reconnect's HELLO made the session
                        rtype, rpayload = reply
                        break
                    if not timed_out:
                        retransmits += 1
            self._last_rpc = time.monotonic()
            self._handle_reply(rtype, rpayload, rpc_mid=rpc_mid)
            return rtype, rpayload

    def _heartbeat_loop(self) -> None:
        interval = self._heartbeat_interval
        while not self._hb_stop.wait(min(interval / 4.0, 1.0)):
            if self.disconnected.is_set():
                return
            if time.monotonic() - self._last_rpc < interval:
                continue
            try:
                self.ping()
            except (ConnectionError, OSError):
                return  # the request path latched what happened
            # anything else (an InjectedCrash) propagates

    @property
    def faults_injected(self) -> int:
        """Wire faults fired on this client's frames."""
        return self._faults.injected

    def ping(self) -> int:
        """Heartbeat RPC; refreshes the cached learner step."""
        self._request(T_PING, b"")
        return self.learner_step

    def _flow_blocked(self) -> bool:
        return (self._flow_params.enabled and self.credits is not None
                and self.credits <= 0)

    def _send_exp(self, items: list) -> None:
        """One EXP round trip; encoded once, so the byte count is the
        same whatever the resends."""
        if self.credits is not None:
            self.credits -= 1
        payload = encode_chunk(items)
        self._request(T_EXP, payload)
        self.flow_acked_rows += len(items)
        self.flow_acked_bytes += len(payload)

    def send_chunk(self, items: list) -> None:
        """Ship one ``[(Transition, priority)]`` chunk.  With credit (or
        no credit field) the ring's backlog goes first, then this chunk;
        at grant 0 the chunk parks in the drop-oldest ring and the call
        returns."""
        self.flow_minted_rows += len(items)
        with self._lock:
            if self._flow_blocked():
                if self.flow_ring.put(items) and not self._flow_blocked_logged:
                    self._flow_blocked_logged = True
                    print(f"[dcn] slot {self.process_ind}: credit-blocked "
                          f"ring full — shedding oldest experience "
                          f"(counted; newest wins)", flush=True)
                return
            while len(self.flow_ring):
                buffered = self.flow_ring.pop()
                if buffered is None:
                    break
                self._send_exp(buffered)
                if self._flow_blocked():
                    self.flow_ring.put(items)
                    return
            self._send_exp(items)

    def flow_report(self) -> Dict[str, int]:
        """The cumulative counters a tick reports."""
        return {"minted": self.flow_minted_rows,
                "acked": self.flow_acked_rows,
                "acked_bytes": self.flow_acked_bytes,
                "dropped": self.flow_ring.dropped_rows,
                "buffered": self.flow_ring.buffered_rows}

    def get_params(self, min_version: int
                   ) -> Optional[Tuple[np.ndarray, int]]:
        _, payload = self._request(T_GETP, struct.pack("!Q", min_version))
        (version,) = struct.unpack("!Q", payload[:8])
        if version == 0:
            return None
        return np.frombuffer(payload[8:], dtype=np.float32).copy(), version

    def tick(self, actor_steps: int = 0,
             stats: Optional[Dict[str, float]] = None) -> int:
        msg: Dict[str, Any] = {"actor_steps": actor_steps}
        if stats:
            msg["stats"] = stats
        if self._flow_params.enabled and self.flow_minted_rows:
            msg["flow"] = self.flow_report()
        with self._lock:
            # under the lock, so ticks reach the wire in seq order; a
            # resend reuses the same bytes
            self._tick_seq += 1
            msg["seq"] = self._tick_seq
            self._request(T_TICK, json.dumps(msg).encode())
        return self.learner_step

    def close(self) -> None:
        try:
            # what the grant allows of the ring's backlog ships; the rest
            # stays counted as buffered
            if len(self.flow_ring) and not self.disconnected.is_set():
                with self._lock:
                    while not self._flow_blocked():
                        buffered = self.flow_ring.pop()
                        if buffered is None:
                            break
                        self._send_exp(buffered)
        except (ConnectionError, OSError):
            pass
        self._closed = True
        if self._hb_thread is not None:
            self._hb_stop.set()
            self._hb_thread.join(2.0)
        try:
            with self._lock:
                _send_frame(self._sock, T_BYE, b"")
                self._sock.close()
        except (ConnectionError, OSError):
            pass


# -- the adapters the actor harness binds (agents/actor.py) --------------------------

class _ChunkSink:
    """The queue end ``QueueFeeder`` puts on: one put is one EXP frame.
    The feeder's chunk holds bare Transitions; they travel with no
    priority."""

    def __init__(self, client: DcnClient):
        self._client = client

    def put(self, chunk: list, timeout: Optional[float] = None) -> None:
        items = [(t, None) for t in chunk]
        if isinstance(chunk, tracing.TracedChunk):
            items = tracing.TracedChunk(items, trace_id=chunk.trace_id,
                                        born=chunk.born)
        self._client.send_chunk(items)


class RemoteMemory(QueueFeeder):
    """The actor's feed endpoint over the wire: ``QueueFeeder``'s chunks,
    flush faults and traces, with the queue replaced by the client."""

    def __init__(self, client: DcnClient, chunk: int = 64):
        super().__init__(_ChunkSink(client), chunk=chunk)


class RemoteParamStore:
    """``ParamStore``'s read surface over the wire."""

    def __init__(self, client: DcnClient):
        self._client = client

    def fetch(self, min_version: int = 0
              ) -> Optional[Tuple[np.ndarray, int]]:
        return self._client.get_params(min_version)

    # written against self.fetch alone
    wait = ParamStore.wait


class _StepShim:
    """``mp.Value``'s ``value`` for the clock's learner-step reads."""

    def __init__(self, client: DcnClient):
        self._client = client

    @property
    def value(self) -> int:
        return self._client.learner_step


class RemoteClock:
    """``GlobalClock``'s surface for a remote actor: actor steps gather
    here and flush as a tick every ``flush_every`` steps or ``max_age``
    seconds; the learner step is the latest reply's.  ``progress`` (the
    actor host's ``ProgressBoard``) takes the hang watchdog's marks."""

    def __init__(self, client: DcnClient, flush_every: int = 256,
                 max_age: float = 2.0):
        self._client = client
        self._flush_every = flush_every
        self._max_age = max_age
        self._pending = 0
        self._last_flush = time.monotonic()
        self.learner_step = _StepShim(client)
        self.progress = None

    def bump_progress(self, label: str, n: int = 1) -> None:
        if self.progress is not None:
            self.progress.bump(label, n)

    @property
    def stop(self) -> threading.Event:
        return self._client.stop

    def add_actor_steps(self, n: int = 1) -> int:
        self._pending += n
        now = time.monotonic()
        if (self._pending >= self._flush_every
                or now - self._last_flush > self._max_age):
            self.flush()
        return self._client.learner_step

    def flush(self) -> None:
        pending, self._pending = self._pending, 0
        self._last_flush = time.monotonic()
        try:
            self._client.tick(actor_steps=pending)
        except (ConnectionError, OSError):
            # a terminal loss: the steps stay queued (they are the fleet's
            # Ape-X step count); done() ends the loop on ``disconnected``
            self._pending += pending

    def done(self, steps: int) -> bool:
        if (self._client.stop.is_set()
                or self._client.disconnected.is_set()):
            return True
        if time.monotonic() - self._last_flush > self._max_age:
            self.flush()
        return self._client.learner_step >= steps


class RemoteStats:
    """``ActorStats.add`` over the wire, one tick a call; shed (counted)
    at brownout tier 1 and above."""

    def __init__(self, client: DcnClient):
        self._client = client

    def add(self, **kv: float) -> None:
        if flow.telemetry_shed():
            flow.note_shed("stats", 1)
            return
        try:
            self._client.tick(stats={k: float(v) for k, v in kv.items()})
        except (ConnectionError, OSError):
            pass
