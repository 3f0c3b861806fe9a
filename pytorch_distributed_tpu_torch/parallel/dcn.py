"""The DCN wire: remote actors' experience in, parameters out, clocks and
stats both ways, the learner replicas' gradient rounds and the gateway's
HA journal — the port of pytorch_distributed_tpu/parallel/dcn.py:
framing (:139-258), the chunk codec (:264-373), the replica and HA knobs
(``resolve_replica``/``export_replica_env`` :381-421,
``resolve_gateway``/``export_gateway_env`` :428-467),
``parse_endpoints`` (:470-495), ``GatewayJournal`` with its digests
(:498-715), the round, reply and priority codecs (:718-858),
``ReplicaRegistry`` (:860-1430), ``ReplicaFenced``,
``LocalReplicaChannel`` and ``ReplicaClient`` (:1433-1770),
``DcnGateway`` (:1776-2919, its HA half :1980-2272 and every verb but
the shard plane's, which it answers as the reference's gateway does
with no shard plane), ``feed_queue_of`` (:2921-2944), the sessionless
helpers ``fetch_status``, ``fetch_profile`` and ``push_metrics``
(:2951-3063), ``redial_backoff`` (:3070-3083), ``DcnDisconnected``,
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

The replica plane (``ReplicaRegistry``): N data-parallel learner
replicas hold renewable leases with monotonic generations on the lead
gateway; a lease missed for ``lease_s`` expires and fences its holder,
whose later gradient or priority writes are counted rejects.  Each round
reduces the members' gradients as a mean in ascending replica order, so
a round of one member returns that member's gradient to the bit; a
member silent for a lease window after a round started is expelled and
the round completes over the survivors.  A replica entering mid-run
waits on a join barrier: rank 0 commits a checkpoint epoch the joiner
loads before it activates.

The HA plane (``GatewayParams.enabled`` and a log dir): the primary
journals slot claims and its state (tick high-waters, clocks, the flow
ledger) to an fsynced WAL per term under ``{log_dir}/gateway/``; a
standby pulls it over ``T_SYNC``, refuses session verbs until it
promotes (after a lease window of failed pulls) by writing a higher term
to ``TERM.json``; a primary that reads a higher term on disk fences its
own writes.  With the plane off nothing of it is on the wire or on disk.

Observability: an EXP frame carries its chunk's trace id and birth wall
as savez columns, and the gateway records the wire hop; claims, fences,
releases, reconnects, terminal losses, promotions, term fences and
lease events land in the flight recorder (roles ``gateway``,
``replica-registry`` and ``dcn-client-<slot>``); ``T_STATUS`` answers
``status_snapshot`` to sessionless probes (``fetch_status``),
``T_PROFILE`` a profile window from the gateway's ``profiler`` provider
(``fetch_profile``) and ``T_METRICS`` pushes rows into its
``metrics_sink`` (``push_metrics``).

Every socket here binds or dials what the caller names; tests bind port
0 and read ``DcnGateway.port``.
"""

from __future__ import annotations

import hashlib
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
T_PROFILE = 10  # JSON {seconds, label?, role} -> JSON {trace_dir} | {error}
T_METRICS = 11  # JSON {rows, offset?, host?} -> JSON {accepted, wall}
T_RLEASE = 12   # JSON lease verb          -> JSON reply
T_RGRAD = 13    # savez round submission   -> savez round reply
T_RPRIO = 14    # savez |TD| write-back    -> JSON {status}
T_SYNC = 15     # JSON {since}             -> JSON journal records
# the shard plane's verbs, answered as the reference's gateway answers
# them with no shard plane
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


def _pack_noshard_reply() -> bytes:
    """The ``T_SSAMPLE`` reply of a gateway with no shard plane (status 3,
    the reference's ``SSTAT_NOSHARD``)."""
    out = io.BytesIO()
    np.savez(out, status=np.asarray([3], np.int64),
             generation=np.asarray([0], np.int64))
    return out.getvalue()


# -- the replica and HA planes' knobs --------------------------------------

def resolve_replica(rp=None):
    """ReplicaParams + ``TPU_APEX_REPLICA_<FIELD>`` env overrides — the
    same override-by-env contract as the health/perf/flow planes
    (flow.resolve_flow is the template).  Returns a NEW instance; the
    input is never mutated (Options rides spawn pickles)."""
    import dataclasses

    from pytorch_distributed_tpu_torch.config import ReplicaParams

    if rp is None:
        rp = ReplicaParams()
    changes: Dict[str, Any] = {}
    for f in dataclasses.fields(rp):
        raw = os.environ.get("TPU_APEX_REPLICA_" + f.name.upper())
        if raw is None:
            continue
        cur = getattr(rp, f.name)
        if isinstance(cur, bool):
            changes[f.name] = raw.strip().lower() not in (
                "0", "false", "off", "no", "")
        elif isinstance(cur, int) and not isinstance(cur, bool):
            changes[f.name] = int(float(raw))
        elif isinstance(cur, float):
            changes[f.name] = float(raw)
        else:
            changes[f.name] = raw.strip()
    return dataclasses.replace(rp, **changes) if changes else rp


def export_replica_env(rp) -> None:
    """Export a RESOLVED ReplicaParams into the environment so spawn
    children resolve the same plane the topology configured
    programmatically.  setdefault: an operator's explicit env wins."""
    import dataclasses

    for f in dataclasses.fields(rp):
        val = getattr(rp, f.name)
        if val != f.default:
            os.environ.setdefault("TPU_APEX_REPLICA_" + f.name.upper(),
                                  str(val))


# gateway high availability: durable control plane + warm-standby failover
# with fenced promotion

def resolve_gateway(gp=None):
    """GatewayParams + ``TPU_APEX_GATEWAY_<FIELD>`` env overrides — the
    same override-by-env contract as the health/perf/flow/replica
    planes.  Returns a NEW instance; the input is never mutated."""
    import dataclasses

    from pytorch_distributed_tpu_torch.config import GatewayParams

    if gp is None:
        gp = GatewayParams()
    changes: Dict[str, Any] = {}
    for f in dataclasses.fields(gp):
        raw = os.environ.get("TPU_APEX_GATEWAY_" + f.name.upper())
        if raw is None:
            continue
        cur = getattr(gp, f.name)
        if isinstance(cur, bool):
            changes[f.name] = raw.strip().lower() not in (
                "0", "false", "off", "no", "")
        elif isinstance(cur, int) and not isinstance(cur, bool):
            changes[f.name] = int(float(raw))
        elif isinstance(cur, float):
            changes[f.name] = float(raw)
        else:
            changes[f.name] = raw.strip()
    return dataclasses.replace(gp, **changes) if changes else gp


def export_gateway_env(gp) -> None:
    """Export a RESOLVED GatewayParams into the environment so spawn
    children (remote actor mains, the standby runner) resolve the same
    HA plane the topology configured.  setdefault: an operator's
    explicit env wins."""
    import dataclasses

    for f in dataclasses.fields(gp):
        val = getattr(gp, f.name)
        if val != f.default:
            os.environ.setdefault("TPU_APEX_GATEWAY_" + f.name.upper(),
                                  str(val))


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


# -- the HA journal -----------------------------------------------------------

def _rec_digest(seq: int, kind: str, data: Dict[str, Any]) -> str:
    """Per-record WAL digest: seq|kind|canonical-json, first 12 hex of
    sha256 — enough to catch torn/bit-rotted lines, cheap to verify on
    every recovery scan."""
    blob = f"{seq}|{kind}|{json.dumps(data, sort_keys=True)}"
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


class GatewayJournal:
    """Append-only fsynced WAL for the gateway's mutable control state
    under ``{log_dir}/gateway/`` — the same shared-storage, atomic-rename
    and digest discipline as the checkpoint epochs.

    Layout::

        {log_dir}/gateway/TERM.json          # {"term", "wall", "sha"}
        {log_dir}/gateway/wal-<term>.jsonl   # one JSON record per line
        {log_dir}/gateway/standby/wal-0.jsonl  # standby's applied copy

    ``TERM.json`` is the fencing substrate: it is only ever replaced
    atomically (tmp + ``os.replace``) with a strictly larger term, and
    every HA gateway re-reads it (mtime-gated) before applying writes —
    a resurrected primary whose term is below the on-disk term fences
    itself.  Each WAL line is ``{"seq", "kind", "data", "sha"}`` with a
    per-record digest; recovery scans the newest term's file, SKIPS a
    torn/undigestable trailing record (the ``read_scalars`` discipline)
    and falls back to a counted clean slate on an empty/corrupt journal
    — torn state is never fatal, only warm-start warmth is lost.
    Records carry ABSOLUTE values (cumulative ledgers, incarnation and
    seq high-waters), so applying any suffix — or the whole file twice —
    is idempotent by construction."""

    def __init__(self, root: str, standby: bool = False):
        self.dir = os.path.join(root, "gateway")
        if standby:
            # the standby journals its APPLIED copy of the stream in a
            # subdir so it never touches the primary's term WAL; on the
            # shared log_dir both survive either host
            self.dir = os.path.join(self.dir, "standby")
        os.makedirs(self.dir, exist_ok=True)
        self._standby = standby
        self._lock = threading.Lock()
        self._fh = None
        self.term = 0          # term this journal is appending under
        self.seq = 0           # last appended/applied record seq
        self.base_seq = 0      # first seq held in the in-memory tail
        self.appends = 0
        self.recover_warnings = 0
        # in-memory tail served over T_SYNC; bounded — a standby that
        # falls further behind than this gets base_seq back and re-pulls
        # from there (records are idempotent, so the overlap is safe)
        self._tail: List[Dict[str, Any]] = []
        self._tail_max = 65536

    # -- term file (the fencing substrate) --------------------------------

    def _term_path(self) -> str:
        # the term file always lives at the SHARED top-level gateway dir
        # (even for the standby journal, which writes it on promotion)
        d = os.path.dirname(self.dir) if self._standby else self.dir
        return os.path.join(d, "TERM.json")

    def read_term(self) -> int:
        """Digest-checked read of the on-disk term; torn/corrupt/missing
        reads as 0 with a counted warning (never fatal — a gateway that
        cannot prove a HIGHER term exists keeps leading)."""
        try:
            with open(self._term_path()) as fh:
                doc = json.load(fh)
            term = int(doc["term"])
            want = _rec_digest(term, "term", {"wall": doc["wall"]})
            if doc.get("sha") != want:
                self.recover_warnings += 1
                return 0
            return term
        except FileNotFoundError:
            return 0
        except Exception:
            self.recover_warnings += 1
            return 0

    def write_term(self, term: int) -> None:
        """Atomically publish a new (strictly larger) term — tmp +
        ``os.replace``, digest-stamped, fsynced before the rename so a
        torn publish can never read as valid."""
        path = self._term_path()
        wall = time.time()
        doc = {"term": int(term), "wall": wall,
               "sha": _rec_digest(int(term), "term", {"wall": wall})}
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(doc, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)

    # -- the WAL itself ---------------------------------------------------

    def _wal_path(self, term: int) -> str:
        return os.path.join(self.dir, f"wal-{term:08d}.jsonl")

    def start_term(self, term: int) -> None:
        """Open (append mode) the WAL for ``term``; subsequent appends
        land there.  seq continues from whatever recover() found so the
        (term, seq) pair is globally monotonic."""
        with self._lock:
            if self._fh is not None:
                self._fh.close()
            self.term = int(term)
            self._fh = open(self._wal_path(self.term), "a")

    def append(self, kind: str, data: Dict[str, Any]) -> int:
        """fsynced append of one control record; returns its seq.
        Raises OSError if the backing store is gone — the gateway treats
        a failed append as self-fencing (can't journal => can't lead)."""
        with self._lock:
            if self._fh is None:
                raise OSError("journal not open")
            self.seq += 1
            rec = {"seq": self.seq, "kind": kind, "data": data,
                   "sha": _rec_digest(self.seq, kind, data)}
            self._fh.write(json.dumps(rec, sort_keys=True) + "\n")
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self.appends += 1
            self._tail.append(rec)
            if len(self._tail) > self._tail_max:
                drop = len(self._tail) - self._tail_max
                del self._tail[:drop]
            self.base_seq = self._tail[0]["seq"] if self._tail else self.seq
            return self.seq

    def apply(self, rec: Dict[str, Any]) -> bool:
        """Standby side: persist one pulled record verbatim (same seq
        numbering as the primary) and advance the applied offset.
        Already-applied seqs are ignored — the resync overlap after a
        standby restart is a no-op, not a double-count."""
        seq = int(rec.get("seq", 0))
        with self._lock:
            if seq <= self.seq:
                return False
            if self._fh is None:
                self._fh = open(self._wal_path(0), "a")
            self.seq = seq
            self._fh.write(json.dumps(rec, sort_keys=True) + "\n")
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self.appends += 1
            self._tail.append(rec)
            if len(self._tail) > self._tail_max:
                del self._tail[:len(self._tail) - self._tail_max]
            self.base_seq = self._tail[0]["seq"] if self._tail else self.seq
            return True

    def records_since(self, since: int) -> Tuple[int, List[Dict[str, Any]]]:
        """(base_seq, records with seq > since) from the in-memory tail —
        the T_SYNC reply body.  A ``since`` below base_seq gets the whole
        tail (idempotent records make the overlap harmless)."""
        with self._lock:
            recs = [r for r in self._tail if r["seq"] > since]
            return self.base_seq, recs

    def recover(self) -> Tuple[int, List[Dict[str, Any]]]:
        """Scan this journal dir newest-term-first and return
        ``(term, records)`` of the first file that yields any valid
        records — digest-verifying every line, skipping a torn or
        undigestable TRAILING record, and counting (never raising) a
        clean-slate fallback on empty/corrupt journals."""
        try:
            names = sorted((n for n in os.listdir(self.dir)
                            if n.startswith("wal-")
                            and n.endswith(".jsonl")), reverse=True)
        except OSError:
            self.recover_warnings += 1
            return 0, []
        top_term = max((int(n[len("wal-"):-len(".jsonl")]) for n in names),
                       default=0)
        for name in names:
            recs: List[Dict[str, Any]] = []
            torn = 0
            try:
                with open(os.path.join(self.dir, name)) as fh:
                    lines = fh.read().split("\n")
            except OSError:
                self.recover_warnings += 1
                continue
            for line in lines:
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                    if rec.get("sha") != _rec_digest(
                            int(rec["seq"]), rec["kind"], rec["data"]):
                        raise ValueError("digest mismatch")
                except Exception:
                    torn += 1
                    continue
                recs.append(rec)
            if torn:
                self.recover_warnings += torn
            if recs:
                with self._lock:
                    self.seq = max(int(r["seq"]) for r in recs)
                    self._tail = recs[-self._tail_max:]
                    self.base_seq = self._tail[0]["seq"]
                # the TERM floor is the newest file seen even when that
                # file itself was empty — a bump can never collide
                return top_term, recs
            if name == names[0]:
                # newest journal empty/corrupt: counted clean slate
                self.recover_warnings += 1
        return top_term, []

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


# the in-process registry handle: FleetTopology sets it at construction
# so the lead learner (which runs in the gateway's own process) joins
# the replica plane through a LocalReplicaChannel instead of dialling
# its own gateway over loopback
_LOCAL_REGISTRY: List[Any] = [None]


def set_local_registry(registry) -> None:
    _LOCAL_REGISTRY[0] = registry


def local_registry():
    return _LOCAL_REGISTRY[0]


# T_RGRAD / T_RPRIO round status codes (int64 ``status`` column)
RSTAT_OK = 0        # round completed; reduced gradient + merge attached
RSTAT_FENCED = 1    # submitter's lease is gone / generation superseded
RSTAT_STALE = 2     # stale round or stale generation: counted reject
RSTAT_TIMEOUT = 3   # round could not complete (wedged registry guard)
RSTAT_NOREG = 4     # no ReplicaRegistry wired on this gateway

# every savez column the replica round codec may ship, either direction
# (the declared wire schema, same contract as WIRE_COLUMNS for EXP
# frames; the codec helpers below are the only writers/readers)
REPLICA_WIRE_COLUMNS = (
    "meta", "ok", "grad", "pidx", "ptd",            # submission
    "status", "generation", "round", "members",     # reply control
    "applied", "epoch_due", "wsrc", "wcount", "widx", "wtd")


def _pack_round(replica: int, generation: int, round_idx: int, ok: bool,
                grad: np.ndarray, pidx: Optional[np.ndarray] = None,
                ptd: Optional[np.ndarray] = None) -> bytes:
    cols = {
        "meta": np.asarray([replica, generation, round_idx], np.int64),
        "ok": np.asarray([1 if ok else 0], np.int64),
        "grad": np.ascontiguousarray(grad, dtype=np.float32),
    }
    if pidx is not None and len(pidx):
        cols["pidx"] = np.ascontiguousarray(pidx, dtype=np.int32)
        cols["ptd"] = np.ascontiguousarray(ptd, dtype=np.float32)
    out = io.BytesIO()
    np.savez(out, **cols)
    return out.getvalue()


def _unpack_round(payload: bytes) -> dict:
    try:
        with np.load(io.BytesIO(payload)) as z:
            cols = {k: z[k] for k in z.files}
    except Exception as e:
        raise ConnectionError(f"unparseable RGRAD payload: {e!r}")
    meta = cols.get("meta")
    if meta is None or meta.shape != (3,) or meta.dtype.kind not in "iu":
        raise ValueError("malformed RGRAD frame: bad meta column")
    return cols


def _pack_round_reply(status: int, generation: int = 0, round_idx: int = 0,
                      grad: Optional[np.ndarray] = None,
                      members: Tuple[int, ...] = (), applied: int = 0,
                      epoch_due: bool = False,
                      writebacks: Optional[List[Tuple[int, np.ndarray,
                                                      np.ndarray]]] = None
                      ) -> bytes:
    cols = {
        "status": np.asarray([status], np.int64),
        "generation": np.asarray([generation], np.int64),
        "round": np.asarray([round_idx], np.int64),
        "members": np.asarray(list(members), np.int64),
        "applied": np.asarray([applied], np.int64),
        "epoch_due": np.asarray([1 if epoch_due else 0], np.int64),
    }
    if grad is not None:
        cols["grad"] = np.ascontiguousarray(grad, dtype=np.float32)
    if writebacks:
        # merged |TD| write-backs, one group per contributing replica in
        # the deterministic merge order: every replica applies ALL
        # groups sequentially, so the N local PER rings stay one
        # logical priority plane
        cols["wsrc"] = np.asarray([s for s, _i, _t in writebacks],
                                  np.int64)
        cols["wcount"] = np.asarray([len(i) for _s, i, _t in writebacks],
                                    np.int64)
        cols["widx"] = np.concatenate(
            [np.asarray(i, np.int32) for _s, i, _t in writebacks])
        cols["wtd"] = np.concatenate(
            [np.asarray(t, np.float32) for _s, _i, t in writebacks])
    out = io.BytesIO()
    np.savez(out, **cols)
    return out.getvalue()


def _unpack_round_reply(payload: bytes) -> dict:
    try:
        with np.load(io.BytesIO(payload)) as z:
            cols = {k: z[k] for k in z.files}
    except Exception as e:
        raise ConnectionError(f"unparseable RGRAD reply: {e!r}")
    out: Dict[str, Any] = {
        "status": int(cols["status"][0]),
        "generation": int(cols.get("generation", [0])[0]),
        "round": int(cols.get("round", [0])[0]),
        "members": [int(m) for m in cols.get("members", [])],
        "applied": int(cols.get("applied", [0])[0]),
        "epoch_due": bool(cols.get("epoch_due", [0])[0]),
        "grad": cols.get("grad"),
    }
    wb: List[Tuple[int, np.ndarray, np.ndarray]] = []
    if "wsrc" in cols and len(cols["wsrc"]):
        off = 0
        for s, n in zip(cols["wsrc"], cols["wcount"]):
            wb.append((int(s), cols["widx"][off:off + int(n)],
                       cols["wtd"][off:off + int(n)]))
            off += int(n)
    out["writebacks"] = wb
    return out


def _pack_prio(replica: int, generation: int, pidx: np.ndarray,
               ptd: np.ndarray) -> bytes:
    out = io.BytesIO()
    np.savez(out,
             meta=np.asarray([replica, generation], np.int64),
             pidx=np.ascontiguousarray(pidx, dtype=np.int32),
             ptd=np.ascontiguousarray(ptd, dtype=np.float32))
    return out.getvalue()



class ReplicaRegistry:
    """Gateway-side membership + round coordinator for the elastic
    multi-learner plane.

    **Lease-fenced membership.**  Each replica holds a renewable lease
    stamped with a monotonic GENERATION number (one counter across the
    registry — every acquire, including a rejoin, consumes a fresh
    generation, so generations totally order membership history).  A
    lease neither renewed nor exercised (a round submission is proof of
    life) within ``lease_s`` expires: the member is removed, counted,
    and FENCED — any later gradient or priority write-back stamped with
    its dead generation is a counted reject (``stale_grad_rejected`` /
    ``stale_prio_rejected``), never applied.  A second acquire for the
    same replica id with a HIGHER incarnation evicts the stale holder
    (the double-lease case: a replacement process fencing its own
    half-open predecessor — the gateway's slot fencing lifted to the
    learner plane); equal/lower incarnations are refused.

    **Fault-tolerant rounds.**  ``submit`` blocks until round ``r`` has
    contributions from every live member whose ``joined_round <= r``.
    Membership can shrink while waiting: expiry (dead renewer) or the
    ROUND-STALL rule — once the first contribution lands, members still
    silent after one lease window are expelled (this is how a HUNG
    replica whose background renewer is still faithfully renewing gets
    fenced: leases prove liveness, rounds prove progress).  The round
    then completes over the surviving set: the reduced gradient is the
    mean over the surviving contributions summed in ascending replica
    order (a fixed fp32 reduction order, so an N=1 completion is
    bit-identical to the solo learner's own gradient), and the merged
    per-replica |TD| write-backs ride the reply in the same order so
    every survivor applies the identical priority mutation sequence.

    **Elastic rejoin.**  A mid-training acquire schedules a JOIN
    BARRIER: the round before the joiner's entry round replies
    ``epoch_due`` to every member (rank 0 commits a checkpoint epoch of
    the post-round state — utils/checkpoint.save_epoch), survivors then
    hold at the entry round until the joiner loads that exact epoch and
    ``activate``s (or its ``join_timeout_s`` lapses and the join is
    cancelled).  State convergence is by construction: the joiner
    resumes the very bytes the survivors checkpointed.

    Pure stdlib and numpy, so the drills run the whole plane in
    milliseconds."""

    def __init__(self, params=None, writer=None):
        self.params = resolve_replica(params)
        self._cond = threading.Condition()
        self._gen = 0
        # replica -> {generation, incarnation, expires, joined_round,
        #             round, renews, born, marks: [(mono, round)]}
        self._members: Dict[int, Dict[str, Any]] = {}
        # fenced generations: replica -> last dead generation (the
        # last-generation-wins check reads the LIVE table; this map is
        # observability for drills)
        self._fenced_gen: Dict[int, int] = {}
        self._rounds: Dict[int, Dict[str, Any]] = {}
        self._round_done = -1
        # replica -> {generation, join_round, deadline}
        self._joining: Dict[int, Dict[str, Any]] = {}
        self._epoch_due: Dict[int, bool] = {}   # round -> commit due
        self._epoch_step: Dict[int, int] = {}   # round -> committed step
        self._oob_writebacks: List[Tuple[int, np.ndarray,
                                         np.ndarray]] = []
        self._churn: List[float] = []  # walls of expiry/fence events
        self._writer = writer
        self._last_emit = 0.0
        self._recorder = flight_recorder.get_recorder("replica-registry")
        # counters (the drill ledger: the drills assert these exactly)
        self.leases_granted = 0
        self.leases_expired = 0
        self.leases_released = 0
        self.lease_fenced = 0           # double-lease evictions
        self.stale_grad_rejected = 0
        self.stale_prio_rejected = 0
        self.prio_merged_rows = 0
        self.rounds_completed = 0
        self.degraded_completions = 0   # completed over a shrunk set
        self.joins_completed = 0
        self.joins_timed_out = 0

    # -- internals (all under self._cond) -----------------------------------

    def _lease_window(self) -> float:
        return max(0.05, float(self.params.lease_s))

    def _emit_locked(self, force: bool = False) -> None:
        """``replica/*`` scalar rows for mission control:
        membership size, current generation, and generation churn
        (lease-consuming events — expiries + fences — in the last 60 s)
        — the series the ``replica_membership`` / ``replica_churn``
        DEFAULT_RULES watch.  Rate-limited; event paths force."""
        if self._writer is None:
            return
        now = time.monotonic()
        if not force and now - self._last_emit < 1.0:
            return
        self._last_emit = now
        wall = time.time()
        cutoff = wall - 60.0
        self._churn = [w for w in self._churn if w >= cutoff]
        try:
            self._writer.scalar("replica/members",
                                float(len(self._members)),
                                step=self._round_done + 1, wall=wall)
            self._writer.scalar("replica/generation", float(self._gen),
                                step=self._round_done + 1, wall=wall)
            self._writer.scalar("replica/generation_churn",
                                float(len(self._churn)),
                                step=self._round_done + 1, wall=wall)
            self._writer.flush()
        except Exception:  # noqa: BLE001 - telemetry is best-effort
            pass

    def _note_churn_locked(self) -> None:
        self._churn.append(time.time())

    def _expire_locked(self, now: float, round_waiting: Optional[int] = None
                       ) -> None:
        """Expire dead leases; with ``round_waiting`` set, also apply
        the round-stall rule to members blocking that round."""
        stalled: List[int] = []
        rnd = self._rounds.get(round_waiting) if round_waiting is not None \
            else None
        for rid, m in list(self._members.items()):
            dead = now > m["expires"]
            reason = "lease-expired"
            if not dead and rnd is not None and not rnd["done"] \
                    and m["joined_round"] <= round_waiting \
                    and rid not in rnd["contribs"] \
                    and rid not in self._joining \
                    and now - rnd["first_at"] > self._lease_window():
                # renewing but not progressing: a hung replica must not
                # wedge the survivors — expelled within one lease window
                dead, reason = True, "round-stall"
            if not dead:
                continue
            del self._members[rid]
            self._fenced_gen[rid] = m["generation"]
            self._joining.pop(rid, None)
            self.leases_expired += 1
            self._note_churn_locked()
            stalled.append(rid)
            self._recorder.record("lease-expired", replica=rid,
                                  generation=m["generation"],
                                  reason=reason)
            print(f"[replica] lease expired: replica {rid} "
                  f"(generation {m['generation']}, {reason})", flush=True)
        if stalled:
            self._emit_locked(force=True)
            self._cond.notify_all()
        # cancel joins whose deadline lapsed (the joiner never loaded
        # its barrier epoch): survivors must proceed
        for rid, j in list(self._joining.items()):
            if now > j["deadline"]:
                del self._joining[rid]
                m = self._members.pop(rid, None)
                if m is not None:
                    self._fenced_gen[rid] = m["generation"]
                self.joins_timed_out += 1
                self._note_churn_locked()
                self._recorder.record("join-timeout", replica=rid)
                self._emit_locked(force=True)
                self._cond.notify_all()

    def _live(self, rid: int, generation: int) -> bool:
        m = self._members.get(rid)
        return m is not None and m["generation"] == generation

    def _required_locked(self, round_idx: int) -> Set[int]:
        return {rid for rid, m in self._members.items()
                if m["joined_round"] <= round_idx}

    # -- lease verbs ---------------------------------------------------------

    def acquire(self, replica: int, incarnation: int) -> dict:
        with self._cond:
            now = time.monotonic()
            self._expire_locked(now)
            held = self._members.get(replica)
            if held is not None:
                if incarnation <= held["incarnation"]:
                    return {"status": "refused",
                            "error": f"replica {replica} already leased "
                                     f"(incarnation {incarnation} <= "
                                     f"{held['incarnation']})"}
                # double-lease: same slot, newer incarnation — fence the
                # stale holder, the newer incarnation wins
                self._fenced_gen[replica] = held["generation"]
                self.lease_fenced += 1
                self._note_churn_locked()
                self._recorder.record("lease-fenced", replica=replica,
                                      old=held["generation"])
            self._gen += 1
            g = self._gen
            open_max = max(self._rounds.keys(), default=self._round_done)
            fresh = self._round_done < 0 and not self._rounds
            if fresh or not (self._members.keys() - {replica}):
                joined = max(0, open_max + 1)
                barrier = None
            else:
                # mid-training join: enter at J, with the round J-1
                # completion carrying the epoch_due flag (rank 0
                # commits the post-(J-1) state the joiner will load)
                joined = open_max + 2
                barrier = joined - 1
                self._epoch_due[barrier] = True
                self._joining[replica] = {
                    "generation": g, "join_round": joined,
                    "deadline": now + max(self.params.join_timeout_s,
                                          self._lease_window())}
            self._members[replica] = {
                "generation": g, "incarnation": int(incarnation),
                "expires": now + self._lease_window(),
                "joined_round": joined, "round": joined - 1,
                "renews": 0, "born": now,
                "marks": [(now, joined - 1)]}
            self.leases_granted += 1
            self._recorder.record("lease-granted", replica=replica,
                                  generation=g, joined_round=joined)
            self._emit_locked(force=True)
            self._cond.notify_all()
            return {"status": "ok", "generation": g,
                    "lease_s": self._lease_window(), "round": joined,
                    "members": sorted(self._members),
                    "epoch_barrier": barrier}

    def renew(self, replica: int, generation: int,
              round_idx: Optional[int] = None) -> dict:
        with self._cond:
            now = time.monotonic()
            self._expire_locked(now)
            if not self._live(replica, generation):
                return {"status": "expired"}
            m = self._members[replica]
            m["expires"] = now + self._lease_window()
            m["renews"] += 1
            if round_idx is not None:
                m["round"] = max(m["round"], int(round_idx))
                m["marks"].append((now, m["round"]))
                del m["marks"][:-8]
            self._emit_locked()
            reply = {"status": "ok", "generation": generation,
                     "members": sorted(self._members)}
            j = self._joining.get(replica)
            if j is not None:
                reply["join"] = {
                    "round": j["join_round"],
                    "epoch_round": j["join_round"] - 1,
                    "epoch_step": self._epoch_step.get(
                        j["join_round"] - 1)}
            return reply

    def release(self, replica: int, generation: int) -> dict:
        with self._cond:
            if self._live(replica, generation):
                m = self._members.pop(replica)
                self._fenced_gen[replica] = m["generation"]
                self._joining.pop(replica, None)
                self.leases_released += 1
                self._recorder.record("lease-released", replica=replica,
                                      generation=generation)
                self._emit_locked(force=True)
                self._cond.notify_all()
            return {"status": "ok"}

    def activate(self, replica: int, generation: int,
                 epoch_step: Optional[int] = None) -> dict:
        """A rejoiner confirms it loaded the barrier epoch: it becomes a
        full member of its join round and the held survivors proceed."""
        with self._cond:
            if not self._live(replica, generation):
                return {"status": "expired"}
            j = self._joining.pop(replica, None)
            if j is not None:
                self.joins_completed += 1
                self._recorder.record("join-activated", replica=replica,
                                      generation=generation,
                                      epoch_step=epoch_step)
            m = self._members[replica]
            now = time.monotonic()
            m["expires"] = now + self._lease_window()
            # restart the entry round's stall clock: the survivors'
            # submissions set first_at while the joiner was still
            # loading the epoch — without this reset, a first-round jit
            # compile longer than one lease window would expel the
            # freshly-activated joiner under the round-stall rule
            rnd = self._rounds.get(m["joined_round"])
            if rnd is not None and not rnd["done"]:
                rnd["first_at"] = now
            self._emit_locked(force=True)
            self._cond.notify_all()
            return {"status": "ok", "round": m["joined_round"],
                    "members": sorted(self._members)}

    def note_epoch(self, replica: int, generation: int, round_idx: int,
                   step: int) -> dict:
        """Rank 0 reports the barrier epoch committed at ``step`` —
        the signal a pending joiner polls for (via ``renew``)."""
        with self._cond:
            if not self._live(replica, generation):
                return {"status": "expired"}
            self._epoch_step[round_idx] = int(step)
            self._epoch_due.pop(round_idx, None)
            self._recorder.record("epoch-committed", round=round_idx,
                                  step=step, by=replica)
            self._cond.notify_all()
            return {"status": "ok"}

    # -- the generation-stamped allreduce round ------------------------------

    def submit(self, replica: int, generation: int, round_idx: int,
               grad: np.ndarray, ok: bool = True,
               pidx: Optional[np.ndarray] = None,
               ptd: Optional[np.ndarray] = None) -> dict:
        """One blocking round contribution; returns the completed
        round's result (or a fenced/stale/timeout status).  The caller's
        serve thread (or the local channel's caller) parks on the
        registry condition; submitting and waiting both count as proof
        of life, so a member blocked on a slow peer is never expired —
        the PEER is, by the round-stall rule."""
        deadline_s = self.params.round_timeout_s or \
            (3.0 * self._lease_window() + 1.0)
        with self._cond:
            now = time.monotonic()
            self._expire_locked(now)
            done = self._rounds.get(round_idx)
            if done is not None and done["done"] \
                    and replica in done["contribs"] \
                    and done["contribs"][replica][0] == generation:
                # idempotent retransmit: this replica already completed
                # this round and its reply ack was lost to a wire blip
                # — hand the retained result back instead of fencing a
                # perfectly live member for retrying
                return done["result"]
            if round_idx <= self._round_done \
                    or (not self._live(replica, generation)):
                stale = not self._live(replica, generation)
                self.stale_grad_rejected += 1
                self._recorder.record("stale-grad-rejected",
                                      replica=replica,
                                      generation=generation,
                                      round=round_idx)
                return {"status": (RSTAT_FENCED if stale
                                   else RSTAT_STALE)}
            rnd = self._rounds.get(round_idx)
            if rnd is None:
                rnd = self._rounds[round_idx] = {
                    "contribs": {}, "first_at": now, "done": False,
                    "result": None,
                    "starting_members": len(self._required_locked(
                        round_idx))}
            rnd["contribs"][replica] = (
                generation, bool(ok),
                np.ascontiguousarray(grad, dtype=np.float32),
                (None if pidx is None or not len(pidx)
                 else (np.ascontiguousarray(pidx, np.int32),
                       np.ascontiguousarray(ptd, np.float32))))
            m = self._members[replica]
            m["round"] = max(m["round"], round_idx)
            m["marks"].append((now, round_idx))
            del m["marks"][:-8]
            self._cond.notify_all()
            deadline = now + deadline_s
            while True:
                now = time.monotonic()
                # waiting in a round is progress: refresh my own lease
                me = self._members.get(replica)
                if me is None or me["generation"] != generation:
                    # fenced while waiting (double-lease eviction)
                    return {"status": RSTAT_FENCED}
                me["expires"] = now + self._lease_window()
                self._expire_locked(now, round_waiting=round_idx)
                if rnd["done"]:
                    return rnd["result"]
                self._try_complete_locked(round_idx)
                if rnd["done"]:
                    return rnd["result"]
                # a PENDING joiner legitimately stretches its entry
                # round past the normal wait (it is loading the barrier
                # epoch, bounded by its own join deadline) — survivors
                # must hold for it, not time out under it
                eff = deadline
                for j in self._joining.values():
                    if j["join_round"] <= round_idx:
                        eff = max(eff, j["deadline"] + 1.0)
                if now > eff:
                    return {"status": RSTAT_TIMEOUT}
                self._cond.wait(0.05)

    def _try_complete_locked(self, round_idx: int) -> None:
        rnd = self._rounds.get(round_idx)
        if rnd is None or rnd["done"]:
            return
        required = self._required_locked(round_idx)
        if not required:
            return
        # only contributions from members STILL live at completion time
        # count (a contributor that died mid-round is dropped from the
        # reduce — its generation is fenced, its gradient with it)
        have = {rid for rid in rnd["contribs"]
                if self._live(rid, rnd["contribs"][rid][0])}
        if not required <= have:
            return
        ids = sorted(required)
        valid = [rid for rid in ids if rnd["contribs"][rid][1]]
        reduced = None
        if valid:
            # fixed fp32 reduction order (ascending replica id): at
            # N=1 the "mean" is grad / 1.0 — bit-identical to the solo
            # learner's own gradient, the degraded-parity contract
            acc = rnd["contribs"][valid[0]][2].astype(np.float32,
                                                      copy=True)
            for rid in valid[1:]:
                acc += rnd["contribs"][rid][2]
            reduced = acc / np.float32(len(valid))
        writebacks = [(rid,) + rnd["contribs"][rid][3]
                      for rid in valid
                      if rnd["contribs"][rid][3] is not None]
        if self._oob_writebacks:
            # fenced-validated out-of-round merges land AFTER the
            # in-round groups, in arrival order — identically on every
            # member, so the logical priority plane never forks
            writebacks.extend(self._oob_writebacks)
            self._oob_writebacks = []
        rnd["result"] = {
            "status": RSTAT_OK,
            "grad": reduced,
            "applied": len(valid),
            "members": list(ids),
            "round": round_idx,
            "epoch_due": bool(self._epoch_due.get(round_idx)),
            "writebacks": writebacks,
        }
        rnd["done"] = True
        self._round_done = max(self._round_done, round_idx)
        self.rounds_completed += 1
        bandwidth.note_round()
        if len(ids) < rnd["starting_members"]:
            self.degraded_completions += 1
            self._recorder.record("round-degraded", round=round_idx,
                                  survivors=ids,
                                  started=rnd["starting_members"])
        # retire old round state (completed results are only read by
        # waiters already parked on them; keep a couple for stragglers)
        for r in [r for r in self._rounds if r < round_idx - 2]:
            del self._rounds[r]
        self._emit_locked()
        self._cond.notify_all()

    def merge_prio(self, replica: int, generation: int, pidx: np.ndarray,
                   ptd: np.ndarray) -> dict:
        """Out-of-round |TD| write-back merge with last-generation-wins
        fencing: live-generation writes queue for the next round's
        merged reply; a zombie's stale-generation write is a counted
        reject and never touches the priority plane."""
        with self._cond:
            self._expire_locked(time.monotonic())
            if not self._live(replica, generation):
                self.stale_prio_rejected += 1
                self._recorder.record("stale-prio-rejected",
                                      replica=replica,
                                      generation=generation,
                                      rows=int(len(pidx)))
                return {"status": "stale"}
            self._oob_writebacks.append(
                (replica, np.ascontiguousarray(pidx, np.int32),
                 np.ascontiguousarray(ptd, np.float32)))
            self.prio_merged_rows += int(len(pidx))
            return {"status": "ok"}

    # -- observability -------------------------------------------------------

    def status_block(self) -> dict:
        """The gateway STATUS ``replicas`` block: membership with lease
        ages + per-replica round rates, the generation counter, and the
        fencing/round ledger — the fleet monitor's replicas panel and
        the drills' exact-counter verdicts both read this."""
        with self._cond:
            now = time.monotonic()
            members = {}
            for rid, m in self._members.items():
                rate = None
                marks = m["marks"]
                if len(marks) >= 2 and marks[-1][0] > marks[0][0] + 0.2:
                    rate = round((marks[-1][1] - marks[0][1])
                                 / (marks[-1][0] - marks[0][0]), 2)
                members[str(rid)] = {
                    "generation": m["generation"],
                    "lease_age": round(
                        max(0.0, now - (m["expires"]
                                        - self._lease_window())), 3),
                    "round": m["round"],
                    "renews": m["renews"],
                    "joining": rid in self._joining,
                    "updates_per_s": rate,
                }
            expected = max(1, int(self.params.replicas))
            return {
                "expected": expected,
                "members": members,
                "degraded": len(members) < expected,
                "generation": self._gen,
                "rounds_completed": self.rounds_completed,
                "degraded_completions": self.degraded_completions,
                "counters": {
                    "leases_granted": self.leases_granted,
                    "leases_expired": self.leases_expired,
                    "leases_released": self.leases_released,
                    "lease_fenced": self.lease_fenced,
                    "stale_grad_rejected": self.stale_grad_rejected,
                    "stale_prio_rejected": self.stale_prio_rejected,
                    "prio_merged_rows": self.prio_merged_rows,
                    "joins_completed": self.joins_completed,
                    "joins_timed_out": self.joins_timed_out,
                },
            }

    # -- wire dispatch (called by DcnGateway serve threads) ------------------

    def handle_lease(self, msg: dict) -> dict:
        action = str(msg.get("action", ""))
        try:
            rid = int(msg.get("replica"))
        except (TypeError, ValueError):
            return {"status": "error", "error": "bad replica id"}
        if action == "acquire":
            return self.acquire(rid, int(msg.get("incarnation", 0)))
        gen = int(msg.get("generation", -1))
        if action == "renew":
            r = msg.get("round")
            return self.renew(rid, gen,
                              int(r) if r is not None else None)
        if action == "release":
            return self.release(rid, gen)
        if action == "activate":
            es = msg.get("epoch_step")
            return self.activate(rid, gen,
                                 int(es) if es is not None else None)
        if action == "epoch":
            return self.note_epoch(rid, gen, int(msg.get("round", -1)),
                                   int(msg.get("step", -1)))
        return {"status": "error", "error": f"unknown action {action!r}"}

    def handle_round(self, payload: bytes) -> bytes:
        try:
            cols = _unpack_round(payload)
        except ValueError:
            return _pack_round_reply(RSTAT_STALE)  # malformed: reject
        rid, gen, rnd = (int(x) for x in cols["meta"])
        pidx, ptd = cols.get("pidx"), cols.get("ptd")
        res = self.submit(rid, gen, rnd, cols.get(
            "grad", np.zeros(0, np.float32)),
            ok=bool(cols.get("ok", [1])[0]),
            pidx=pidx, ptd=ptd)
        if res["status"] != RSTAT_OK:
            return _pack_round_reply(res["status"])
        return _pack_round_reply(
            RSTAT_OK, generation=gen, round_idx=res["round"],
            grad=res["grad"], members=res["members"],
            applied=res["applied"], epoch_due=res["epoch_due"],
            writebacks=res["writebacks"])

    def handle_prio(self, payload: bytes) -> dict:
        try:
            with np.load(io.BytesIO(payload)) as z:
                meta = z["meta"]
                pidx = z["pidx"]
                ptd = z["ptd"]
        except Exception as e:
            raise ConnectionError(f"unparseable RPRIO payload: {e!r}")
        return self.merge_prio(int(meta[0]), int(meta[1]), pidx, ptd)


class ReplicaFenced(RuntimeError):
    """This replica's lease is gone (expired, superseded, or the round
    reply said fenced): its generation can no longer write anything.
    The driver's recovery is rejoin-at-a-new-generation or a nonzero
    exit for the supervisor — never a silent continue."""


class LocalReplicaChannel:
    """In-process channel to a ReplicaRegistry — the lead learner runs
    in the gateway's own process, so its replica-plane traffic skips
    the wire (same surface as ReplicaClient; tests use it too)."""

    def __init__(self, registry: ReplicaRegistry, replica: int,
                 incarnation: Optional[int] = None):
        self.registry = registry
        self.replica = replica
        self.incarnation = (int(incarnation) if incarnation is not None
                            else time.time_ns() // 1_000_000)
        self.generation: Optional[int] = None
        self._granted_lease_s: Optional[float] = None
        self.fenced = threading.Event()
        self._renew_stop = threading.Event()
        self._renew_thread: Optional[threading.Thread] = None
        self._round = 0  # last round index reported on renews

    # -- surface shared with ReplicaClient -----------------------------------

    def acquire(self) -> dict:
        self.incarnation += 1
        reply = self.registry.acquire(self.replica, self.incarnation)
        if reply.get("status") != "ok":
            raise ReplicaFenced(
                f"replica {self.replica} lease refused: "
                f"{reply.get('error')}")
        self.generation = reply["generation"]
        # the renew cadence follows the SERVER'S lease window (it rides
        # the acquire reply): a client configured with a longer window
        # than the registry's would otherwise expire between renews
        self._granted_lease_s = float(reply.get("lease_s", 0.0)) or None
        self.fenced.clear()
        return reply

    def renew(self) -> dict:
        if self.generation is None:
            return {"status": "expired"}
        reply = self.registry.renew(self.replica, self.generation,
                                    self._round)
        if reply.get("status") != "ok":
            self.fenced.set()
        return reply

    def start_renewer(self, period: Optional[float] = None) -> None:
        if self._renew_thread is not None \
                and self._renew_thread.is_alive():
            return
        self._renew_stop.clear()
        p = period or (self.registry.params.renew_s
                       or (self._granted_lease_s
                           or self.registry._lease_window()) / 3.0)

        def _loop() -> None:
            while not self._renew_stop.wait(p):
                if self.fenced.is_set():
                    return
                self.renew()

        self._renew_thread = threading.Thread(
            target=_loop, name=f"replica-renew-{self.replica}",
            daemon=True)
        self._renew_thread.start()

    def submit_round(self, round_idx: int, grad: np.ndarray,
                     ok: bool = True,
                     pidx: Optional[np.ndarray] = None,
                     ptd: Optional[np.ndarray] = None) -> dict:
        if self.generation is None:
            raise ReplicaFenced(f"replica {self.replica} has no lease")
        self._round = round_idx
        res = self.registry.submit(self.replica, self.generation,
                                   round_idx, grad, ok=ok,
                                   pidx=pidx, ptd=ptd)
        if res["status"] in (RSTAT_FENCED, RSTAT_STALE):
            self.fenced.set()
        return res

    def merge_prio(self, pidx: np.ndarray, ptd: np.ndarray,
                   generation: Optional[int] = None) -> dict:
        g = self.generation if generation is None else generation
        if g is None:
            raise ReplicaFenced(f"replica {self.replica} has no lease")
        return self.registry.merge_prio(self.replica, g, pidx, ptd)

    def note_epoch(self, round_idx: int, step: int) -> dict:
        return self.registry.note_epoch(self.replica, self.generation,
                                        round_idx, step)

    def activate(self, epoch_step: Optional[int] = None) -> dict:
        return self.registry.activate(self.replica, self.generation,
                                      epoch_step)

    def members(self) -> List[int]:
        reply = self.renew()
        return list(reply.get("members", []))

    def wait_members(self, n: int, timeout: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if len(self.members()) >= n:
                return True
            time.sleep(0.05)
        return False

    def poll_join(self) -> Optional[dict]:
        return self.renew().get("join")

    def release(self) -> None:
        if self.generation is not None and not self.fenced.is_set():
            self.registry.release(self.replica, self.generation)

    def close(self) -> None:
        self._renew_stop.set()
        if self._renew_thread is not None:
            self._renew_thread.join(2.0)
            self._renew_thread = None


class ReplicaClient:
    """Wire twin of LocalReplicaChannel: one replica host's connection
    to the lead gateway's replica plane.  Two sockets — a control
    connection for the lease verbs (sessionless-adjacent: cheap JSON
    RPCs that must keep flowing while a round blocks) and a round
    connection whose T_RGRAD request parks server-side until the round
    completes.  Transport errors surface as ReplicaFenced after one
    redial attempt: the replica plane's recovery story is leases and
    rejoin, not transparent session resumption — a replica that cannot
    reach the registry for a lease window IS expired."""

    def __init__(self, address: Tuple[str, int], replica: int,
                 params=None, incarnation: Optional[int] = None):
        self.address = address
        self.replica = replica
        self.params = resolve_replica(params)
        self.incarnation = (int(incarnation) if incarnation is not None
                            else time.time_ns() // 1_000_000)
        self.generation: Optional[int] = None
        self._granted_lease_s: Optional[float] = None
        self.fenced = threading.Event()
        self._lease_lock = threading.Lock()
        self._round_lock = threading.Lock()
        self._lease_sock: Optional[socket.socket] = None
        self._round_sock: Optional[socket.socket] = None
        self._renew_stop = threading.Event()
        self._renew_thread: Optional[threading.Thread] = None
        self._round = 0

    def _lease_window(self) -> float:
        return max(0.05, float(self.params.lease_s))

    def _rpc(self, which: str, ftype: int, payload: bytes,
             timeout: float) -> Tuple[int, bytes]:
        lock = self._lease_lock if which == "lease" else self._round_lock
        attr = "_lease_sock" if which == "lease" else "_round_sock"
        with lock:
            for attempt in (0, 1):
                sock = getattr(self, attr)
                try:
                    if sock is None:
                        sock = socket.create_connection(
                            self.address, timeout=5.0)
                        sock.setsockopt(socket.IPPROTO_TCP,
                                        socket.TCP_NODELAY, 1)
                        bandwidth.register_socket(sock, "replica",
                                                  self.replica)
                        setattr(self, attr, sock)
                    sock.settimeout(timeout)
                    _send_frame(sock, ftype, payload)
                    return _recv_frame(sock)
                except (ConnectionError, OSError):
                    try:
                        if sock is not None:
                            sock.close()
                    except OSError:
                        pass
                    setattr(self, attr, None)
                    if attempt:
                        raise

    def _lease_rpc(self, msg: dict,
                   timeout: Optional[float] = None) -> dict:
        rtype, payload = self._rpc(
            "lease", T_RLEASE, json.dumps(msg).encode(),
            timeout or max(5.0, self._lease_window()))
        if rtype != T_RLEASE:
            raise ConnectionError(
                f"expected T_RLEASE reply, got frame type {rtype}")
        try:
            return json.loads(payload.decode())
        except (ValueError, UnicodeDecodeError) as e:
            raise ConnectionError(f"undecodable RLEASE reply: {e}")

    # -- surface (mirrors LocalReplicaChannel) -------------------------------

    def acquire(self) -> dict:
        self.incarnation += 1
        reply = self._lease_rpc({"action": "acquire",
                                 "replica": self.replica,
                                 "incarnation": self.incarnation})
        if reply.get("status") != "ok":
            raise ReplicaFenced(
                f"replica {self.replica} lease refused: "
                f"{reply.get('error')}")
        self.generation = reply["generation"]
        # the renew cadence follows the SERVER'S lease window (it rides
        # the acquire reply): a client configured with a longer window
        # than the registry's would otherwise expire between renews
        self._granted_lease_s = float(reply.get("lease_s", 0.0)) or None
        self.fenced.clear()
        return reply

    def renew(self) -> dict:
        if self.generation is None:
            return {"status": "expired"}
        try:
            reply = self._lease_rpc({"action": "renew",
                                     "replica": self.replica,
                                     "generation": self.generation,
                                     "round": self._round})
        except (ConnectionError, OSError):
            return {"status": "error"}
        if reply.get("status") == "expired":
            self.fenced.set()
        return reply

    def start_renewer(self, period: Optional[float] = None) -> None:
        if self._renew_thread is not None \
                and self._renew_thread.is_alive():
            return
        self._renew_stop.clear()
        p = period or (self.params.renew_s
                       or (self._granted_lease_s
                           or self._lease_window()) / 3.0)

        def _loop() -> None:
            while not self._renew_stop.wait(p):
                if self.fenced.is_set():
                    return
                self.renew()

        self._renew_thread = threading.Thread(
            target=_loop, name=f"replica-renew-{self.replica}",
            daemon=True)
        self._renew_thread.start()

    def submit_round(self, round_idx: int, grad: np.ndarray,
                     ok: bool = True,
                     pidx: Optional[np.ndarray] = None,
                     ptd: Optional[np.ndarray] = None) -> dict:
        if self.generation is None:
            raise ReplicaFenced(f"replica {self.replica} has no lease")
        self._round = round_idx
        timeout = (self.params.round_timeout_s
                   or 3.0 * self._lease_window() + 1.0) + 10.0
        rtype, payload = self._rpc(
            "round", T_RGRAD,
            _pack_round(self.replica, self.generation, round_idx, ok,
                        grad, pidx, ptd),
            timeout)
        if rtype != T_RGRAD:
            raise ConnectionError(
                f"expected T_RGRAD reply, got frame type {rtype}")
        res = _unpack_round_reply(payload)
        if res["status"] in (RSTAT_FENCED, RSTAT_STALE):
            self.fenced.set()
        return res

    def merge_prio(self, pidx: np.ndarray, ptd: np.ndarray,
                   generation: Optional[int] = None) -> dict:
        g = self.generation if generation is None else generation
        if g is None:
            raise ReplicaFenced(f"replica {self.replica} has no lease")
        rtype, payload = self._rpc(
            "lease", T_RPRIO, _pack_prio(self.replica, g, pidx, ptd),
            max(5.0, self._lease_window()))
        if rtype != T_RPRIO:
            raise ConnectionError(
                f"expected T_RPRIO reply, got frame type {rtype}")
        return json.loads(payload.decode())

    def note_epoch(self, round_idx: int, step: int) -> dict:
        return self._lease_rpc({"action": "epoch",
                                "replica": self.replica,
                                "generation": self.generation,
                                "round": round_idx, "step": step})

    def activate(self, epoch_step: Optional[int] = None) -> dict:
        return self._lease_rpc({"action": "activate",
                                "replica": self.replica,
                                "generation": self.generation,
                                "epoch_step": epoch_step})

    def members(self) -> List[int]:
        return list(self.renew().get("members", []))

    def wait_members(self, n: int, timeout: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if len(self.members()) >= n:
                return True
            time.sleep(0.05)
        return False

    def poll_join(self) -> Optional[dict]:
        return self.renew().get("join")

    def release(self) -> None:
        if self.generation is None or self.fenced.is_set():
            return
        try:
            self._lease_rpc({"action": "release",
                             "replica": self.replica,
                             "generation": self.generation})
        except (ConnectionError, OSError):
            pass

    def close(self) -> None:
        self._renew_stop.set()
        if self._renew_thread is not None:
            self._renew_thread.join(2.0)
            self._renew_thread = None
        for attr in ("_lease_sock", "_round_sock"):
            sock = getattr(self, attr)
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
                setattr(self, attr, None)


# -- the gateway -----------------------------------------------------------------

class DcnGateway:
    """Accepts remote actors' connections on the learner's host, one serve
    thread each.  ``put_chunk`` takes each decoded ``[(Transition,
    priority), ...]`` chunk (``feed_queue_of`` wires it to the learner's
    ingest).  Each remote slot maps to the ``(incarnation, connection)``
    that holds it; a connection idle past ``idle_deadline`` is dropped
    and frees its slot.  With the flow plane on, ``pressure`` (0..1)
    drives the overload governor whose credits ride every ack.

    The providers answer the sessionless verbs: ``health`` adds to
    STATUS, ``profiler(msg) -> reply`` serves ``T_PROFILE``,
    ``metrics_sink(batch) -> rows`` takes ``T_METRICS`` and ``replicas``
    (a ``ReplicaRegistry``) the replica verbs; a verb with no provider is
    answered with a counted error.  ``gateway_params`` with the HA plane
    on and a ``log_dir`` journal the control state (``ha_role``
    "primary") or pull it from ``sync_from`` and promote (``ha_role``
    "standby"); ``resume_term`` makes a primary that believes a stale
    term, the resurrection drill's."""

    def __init__(self, param_store, clock, actor_stats,
                 put_chunk: Callable[[list], None],
                 host: str = "0.0.0.0", port: int = 0,
                 local_actors: int = 0,
                 idle_deadline: Optional[float] = None,
                 faults: Optional[FaultInjector] = None,
                 health: Optional[Callable[[], dict]] = None,
                 profiler: Optional[Callable[[dict], dict]] = None,
                 metrics_sink: Optional[Callable[[dict], int]] = None,
                 flow_params=None,
                 pressure: Optional[Callable[[], float]] = None,
                 flow_writer=None,
                 replicas: Optional[ReplicaRegistry] = None,
                 gateway_params=None,
                 log_dir: Optional[str] = None,
                 ha_role: str = "primary",
                 sync_from: Optional[Tuple[str, int]] = None,
                 ha_writer=None,
                 resume_term: Optional[int] = None):
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
        # T_PROFILE blocks its own serve thread for the window; the
        # provider's one-window lock refuses concurrent requests
        self._profiler = profiler
        # T_METRICS: one pushed batch in, the rows absorbed out
        self._metrics_sink = metrics_sink
        self._replicas = replicas
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
        # the HA plane: absent unless GatewayParams enables it and a
        # log_dir exists to journal under — with it off the wire stays
        # byte-identical (no term or sync fields, no TERM/WAL files, no
        # STATUS block)
        self._gp = resolve_gateway(gateway_params)
        self._ha = bool(self._gp.enabled and log_dir)
        self._ha_log_dir = log_dir
        self._role = ("standby" if (self._ha and ha_role == "standby")
                      else "primary")
        # a standby refuses session verbs (counted) until promoted, so
        # failing-over clients land on the ConnectionError -> redial
        # path, never the terminal DcnRefused path
        self._serving = not (self._ha and self._role == "standby")
        self._sync_from = sync_from
        self._ha_writer = ha_writer
        self.term = 0
        self.promotions = 0
        self.gateway_term_fenced = 0  # writes rejected on a stale term
        self.standby_refused = 0
        self.failover_lost = 0  # acked-but-undrained rows lost in failover
        self.promoted = threading.Event()
        self._term_fenced = False
        self._journal_dead = False
        self._term_checked = 0.0
        # re-read TERM.json at most this often on the write path: bounds
        # how long a fenced primary can run before noticing, well inside
        # the lease window that gates any promotion in the first place
        self._term_check_every = min(0.05, max(0.01, self._gp.lease_s / 10))
        self._journal: Optional[GatewayJournal] = None
        # absolute ingest totals carried across terms (seeded from the
        # journal / sync stream; own-plane counters add on top)
        self._ha_carry: Dict[str, int] = {}
        self._inc_floor: Dict[int, int] = {}  # journal-seeded slot fencing
        self._ha_thread: Optional[threading.Thread] = None
        self._ha_state_every = max(0.05, min(0.5, self._gp.sync_s))
        self._ha_state_last = 0.0
        self._sync_seq = 0
        self._sync_term = 0
        self._last_sync_ok = time.monotonic()
        if self._ha:
            self._ha_init(resume_term)
        # all the state above exists before the first connection lands
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

    # -- the HA plane ------------------------------------------------------

    def _ha_init(self, resume_term: Optional[int]) -> None:
        """Role-split HA bring-up.  Primary: recover the journal, bump +
        publish the term, warm-seed tick dedup / incarnation floors /
        ledger carry from the recovered records.  Standby: recover its
        own applied-copy journal (the resync offset) and start the sync
        loop.  ``resume_term`` is the drill hook for a RESURRECTED
        primary: it believes the stale term it is given and must
        discover the on-disk one through the fencing path — it never
        bumps, never writes TERM.json, never opens a WAL."""
        if self._role == "standby":
            self._journal = GatewayJournal(self._ha_log_dir, standby=True)
            _term, recs = self._journal.recover()
            self._seed_records(recs)
            self._sync_seq = self._journal.seq
            self._ha_thread = threading.Thread(
                target=self._ha_loop, name="dcn-ha-sync", daemon=True)
            self._ha_thread.start()
            return
        self._journal = GatewayJournal(self._ha_log_dir)
        if resume_term is not None:
            self.term = int(resume_term)
            return
        disk = self._journal.read_term()
        rec_term, recs = self._journal.recover()
        self.term = max(disk, rec_term) + 1
        self._journal.write_term(self.term)
        self._journal.start_term(self.term)
        self._seed_records(recs)
        self._ha_append("start", {"term": self.term})
        self._recorder.record("gateway-term", term=self.term,
                              warm=len(recs))

    def _ha_append(self, kind: str, data: Dict[str, Any]) -> None:
        if self._journal is None:
            return
        try:
            self._journal.append(kind, data)
        except OSError:
            # can't journal => can't lead: losing the shared log dir is
            # indistinguishable from being the partitioned side of a
            # split brain, so writes self-fence from here on (counted
            # per rejected frame in gateway_term_fenced)
            self._journal_dead = True

    def _ha_write_ok(self) -> bool:
        """May this gateway still apply session writes?  False once a
        HIGHER term is visible on disk (a standby promoted over us) or
        our own journal died — the structural split-brain guarantee."""
        if self._term_fenced or self._journal_dead:
            return False
        now = time.monotonic()
        if now - self._term_checked >= self._term_check_every:
            self._term_checked = now
            disk = self._journal.read_term() if self._journal else 0
            if disk > self.term:
                self._term_fenced = True
                self._recorder.record("gateway-fenced",
                                      term=self.term, disk=disk)
                print(f"[dcn] gateway term {self.term} fenced by "
                      f"on-disk term {disk}", flush=True)
                return False
        return True

    def _session_gate(self, ftype: int) -> None:
        """Pre-dispatch HA gate for SESSION verbs only (sessionless
        probes always answer).  An unpromoted standby refuses with a
        counted connection drop — the client's redial path then cycles
        to the next endpoint, never the terminal DcnRefused path — and
        a fenced stale-term gateway's writes/grants are counted rejects
        that are NEVER applied."""
        if ftype in (T_STATUS, T_PROFILE, T_METRICS, T_RLEASE,
                     T_RGRAD, T_RPRIO, T_SYNC, T_SSAMPLE, T_SMASS,
                     T_SPRIO, T_BYE):
            return
        if not self._serving:
            self.standby_refused += 1
            raise ConnectionError(
                "standby gateway: sessions refused before promotion")
        if not self._ha_write_ok():
            self.gateway_term_fenced += 1
            self._recorder.record("stale-term-write",
                                  ftype=ftype, term=self.term)
            raise ConnectionError("gateway term fenced")

    def _ha_ledger(self) -> Dict[str, int]:
        """ABSOLUTE cumulative ingest-side totals across terms: the
        journal carry (what previous terms accounted) plus this
        process's own counters — what the state records persist and the
        sync stream ships, so re-applying any suffix is idempotent."""
        led = {"ingested": int(self._ha_carry.get("ingested", 0)),
               "shed": int(self._ha_carry.get("shed", 0)),
               "quarantined": int(self._ha_carry.get("quarantined", 0)),
               "ingested_bytes":
                   int(self._ha_carry.get("ingested_bytes", 0)),
               "rejected_bytes":
                   int(self._ha_carry.get("rejected_bytes", 0)),
               "shed_bytes": int(self._ha_carry.get("shed_bytes", 0))}
        if self._flow is not None:
            led["ingested"] += int(self._flow.ingested_rows)
            led["shed"] += int(sum(self._flow.shed_rows.values()))
            # the byte legs ride the same absolute-cumulative
            # contract as the row legs, so re-applying any journal
            # suffix stays idempotent
            led["ingested_bytes"] += int(self._flow.ingested_bytes)
            led["rejected_bytes"] += int(self._flow.rejected_bytes)
            led["shed_bytes"] += int(self._flow.shed_bytes)
        with self._slots_lock:
            led["quarantined"] += int(sum(self.quarantined.values()))
        return led

    def _ha_note_state(self) -> None:
        """Rate-limited composite state record on the serve path: tick
        dedup high-waters, clock counters, the cumulative ledger and the
        failover-lost count — everything a warm restart or a promoting
        standby needs to continue the control plane without double
        counting.  One fsynced append per ``_ha_state_every`` window,
        amortized across every chunk in it."""
        if not self._serving or self._journal_dead or self._term_fenced:
            return
        now = time.monotonic()
        if now - self._ha_state_last < self._ha_state_every:
            return
        self._ha_state_last = now
        with self._slots_lock:
            ticks = {str(s): int(q) for s, q in self._tick_seq.items()}
        self._ha_append("state", {
            "tick_seq": ticks,
            "clock": {
                "learner_step": int(self.clock.learner_step.value),
                "actor_step": int(self.clock.actor_step.value)},
            "chunks_in": int(self._ha_carry.get("chunks_in", 0))
            + self.chunks_in,
            "lost": self.failover_lost,
            "ledger": self._ha_ledger()})

    def _seed_records(self, recs: List[Dict[str, Any]]) -> None:
        """Apply journal/sync records to local control state.  Every
        field is an ABSOLUTE value applied through max(), so any replay
        — a restarted standby re-pulling from an old offset, a recovery
        scan over a file containing duplicates — lands exactly once."""
        for rec in recs:
            kind, data = rec.get("kind"), rec.get("data") or {}
            if kind == "slot":
                s = int(data.get("slot", -1))
                inc = int(data.get("inc", -1))
                if s >= 0:
                    with self._slots_lock:
                        if inc > self._inc_floor.get(s, -1):
                            self._inc_floor[s] = inc
            elif kind == "state":
                with self._slots_lock:
                    for s, q in (data.get("tick_seq") or {}).items():
                        si = int(s)
                        if int(q) > self._tick_seq.get(si, -1):
                            self._tick_seq[si] = int(q)
                led = data.get("ledger") or {}
                for k in ("ingested", "shed", "quarantined",
                          "ingested_bytes", "rejected_bytes",
                          "shed_bytes"):
                    v = int(led.get(k, 0))
                    if v > self._ha_carry.get(k, 0):
                        self._ha_carry[k] = v
                ci = int(data.get("chunks_in", 0))
                if ci > self._ha_carry.get("chunks_in", 0):
                    self._ha_carry["chunks_in"] = ci
                lost = int(data.get("lost", 0))
                if lost > self.failover_lost:
                    self.failover_lost = lost

    def _apply_record(self, rec: Dict[str, Any]) -> None:
        """Standby side: digest-check one pulled record, persist it to
        the applied-copy journal (dup seqs are no-ops) and seed state."""
        try:
            if rec.get("sha") != _rec_digest(
                    int(rec["seq"]), rec["kind"], rec["data"]):
                return
        except (KeyError, TypeError, ValueError):
            return
        if self._journal is not None and not self._journal.apply(rec):
            return
        self._seed_records([rec])

    def _ha_emit(self, stale: float) -> None:
        """The standby's health scalar: ``gateway/sync_stale`` is 1.0
        while the primary is unreachable and 0.0 when healthy — the
        telemetry DEFAULT_RULES ``gateway_failover`` alert fires on
        sustained staleness and RESOLVES once the promoted standby keeps
        reporting 0.  Non-HA fleets never report the tag, so the rule is
        inert there (absence rules never fire for never-seen tags)."""
        if self._ha_writer is None:
            return
        try:
            wall = time.time()
            self._ha_writer.scalar("gateway/sync_stale", float(stale),
                                   step=self._sync_seq, wall=wall)
            self._ha_writer.scalar("gateway/term", float(self.term),
                                   step=self._sync_seq, wall=wall)
            self._ha_writer.flush()
        except Exception:  # noqa: BLE001 - telemetry must not kill HA
            pass

    def _sync_once(self) -> bool:
        """One sessionless T_SYNC pull from the primary; returns False
        on any wire/reply failure (the promotion clock's input)."""
        timeout = max(0.5, self._gp.sync_s * 4)
        try:
            sock = socket.create_connection(self._sync_from,
                                            timeout=timeout)
        except OSError:
            return False
        bandwidth.register_socket(sock, "sync")
        try:
            sock.settimeout(timeout)
            _send_frame(sock, T_SYNC,
                        json.dumps({"since": self._sync_seq}).encode())
            rtype, payload = _recv_frame(sock)
            if rtype != T_SYNC:
                return False
            reply = json.loads(payload.decode())
        except (ConnectionError, OSError, ValueError):
            return False
        finally:
            try:
                sock.close()
            except OSError:
                pass
        if reply.get("error"):
            return False
        self._sync_term = max(self._sync_term, int(reply.get("term", 0)))
        for rec in reply.get("records", []):
            self._apply_record(rec)
        self._sync_seq = max(self._sync_seq,
                             int(reply.get("seq", self._sync_seq)))
        return True

    def _promote(self) -> None:
        """Fenced promotion: CAS-bump the on-disk term above everything
        this standby has seen (disk, stream, self), open the new term's
        WAL continuing the global seq numbering, and start serving.  Any
        resurrected predecessor now reads a higher term and fences."""
        disk = self._journal.read_term() if self._journal else 0
        new_term = max(disk, self._sync_term, self.term) + 1
        jr = GatewayJournal(self._ha_log_dir)
        jr.seq = self._journal.seq if self._journal else 0
        try:
            jr.write_term(new_term)
            jr.start_term(new_term)
        except OSError:
            # no shared log dir => cannot prove leadership => stay a
            # (non-serving) standby rather than risk split brain
            self._journal_dead = True
            return
        old, self._journal = self._journal, jr
        if old is not None:
            old.close()
        self.term = new_term
        self.promotions += 1
        self._role = "primary"
        self._serving = True
        self._ha_append("promote", {"term": new_term})
        self._ha_note_state()
        self.promoted.set()
        self._recorder.record("gateway-promoted", term=new_term)
        print(f"[dcn] standby promoted to gateway term {new_term}",
              flush=True)

    def _ha_loop(self) -> None:
        """Warm-standby loop: pull the journal stream on the sync
        cadence; once the pull has failed for one lease window, promote.
        After promotion the loop keeps journaling state and emitting the
        healthy scalar so the ``gateway_failover`` alert resolves."""
        gp = self._gp
        while not self._stop.is_set():
            if self._serving:
                self._ha_note_state()
                self._ha_emit(0.0)
            elif self._sync_once():
                self._last_sync_ok = time.monotonic()
                self._ha_emit(0.0)
            else:
                self._ha_emit(1.0)
                if (time.monotonic() - self._last_sync_ok) > gp.lease_s:
                    self._promote()
            self._stop.wait(gp.sync_s)

    def note_failover_lost(self, rows: int) -> None:
        """Count acked-but-undrained rows that died with the old
        primary's ingest queue.  Only the wiring that discards that
        queue knows the number (the drill, or a fleet restart path) —
        counting it HERE keeps the conservation ledger exact across a
        failover instead of letting the rows silently vanish."""
        self.failover_lost += int(rows)
        self._recorder.record("failover-lost", rows=int(rows))

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
        if self._replicas is not None:
            # membership, generations, lease ages and the fencing ledger
            snap["replicas"] = self._replicas.status_block()
        if self._ha:
            # role, term, sync lag and the failover ledger; absent with
            # the plane off
            snap["gateway"] = {
                "role": self._role,
                "term": self.term,
                "serving": self._serving,
                "fenced": bool(self._term_fenced or self._journal_dead),
                "term_fenced": self.gateway_term_fenced,
                "standby_refused": self.standby_refused,
                "promotions": self.promotions,
                "failover_lost": self.failover_lost,
                "sync_served": self.sync_served,
                "sync_seq": self._sync_seq,
                "sync_term": self._sync_term,
                "sync_age": round(now - self._last_sync_ok, 3),
                "journal_seq": (self._journal.seq
                                if self._journal else 0),
                "journal_appends": (self._journal.appends
                                    if self._journal else 0),
                "recover_warnings": (self._journal.recover_warnings
                                     if self._journal else 0),
                "carry": {k: int(v)
                          for k, v in self._ha_carry.items()},
            }
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
            if self._ha and incarnation <= self._inc_floor.get(ind, -1):
                # the floor the old primary journaled: a zombie actor
                # dialing the promoted gateway is its own fenced
                # predecessor
                return (f"actor slot {ind} incarnation {incarnation} "
                        f"fenced by journaled floor "
                        f"{self._inc_floor[ind]}")
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
            if self._ha and incarnation > self._inc_floor.get(ind, -1):
                self._inc_floor[ind] = incarnation
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

    def _serve_sessionless(self, conn: socket.socket, ftype: int,
                           payload: bytes) -> None:
        """The sessionless verbs: STATUS, the telemetry verbs, the
        replica plane's, ``T_SYNC``, and the shard plane's, which this
        gateway answers as the reference's gateway answers with no shard
        plane.  A verb whose provider is not wired gets a counted error
        reply, never a dead serve thread."""
        if ftype == T_STATUS:
            self.status_served += 1
            _send_frame(conn, T_STATUS,
                        json.dumps(self.status_snapshot()).encode())
        elif ftype == T_PROFILE:
            msg = self._json(payload) if payload else {}
            if self._profiler is None:
                reply = {"error": "no profiler wired on this gateway"}
            else:
                try:
                    reply = self._profiler(msg) or {}
                except Exception as e:  # noqa: BLE001
                    reply = {"error": f"profiler failed: {e!r}"}
            self.profiles_served += 1
            self._recorder.record("profile-served", ok=("error" not in reply),
                                  seconds=msg.get("seconds"))
            _send_frame(conn, T_PROFILE, json.dumps(reply).encode())
        elif ftype == T_METRICS:
            # the reply carries this host's wall clock, which the
            # pusher's offset estimate reads off the RPC midpoint
            msg = self._json(payload) if payload else {}
            if self._metrics_sink is None:
                reply: Dict[str, Any] = {
                    "accepted": 0,
                    "error": "no metrics sink wired on this gateway"}
            else:
                try:
                    n = int(self._metrics_sink(msg) or 0)
                    reply = {"accepted": n}
                    self.metrics_rows += n
                except Exception as e:  # noqa: BLE001
                    reply = {"accepted": 0,
                             "error": f"metrics sink failed: {e!r}"}
            self.metrics_batches += 1
            reply["wall"] = time.time()
            if self._flow is not None and self._flow.governor.tier >= 1:
                # brownout tier 1: the pusher sheds its side (counted)
                reply["brownout"] = self._flow.governor.tier
            _send_frame(conn, T_METRICS, json.dumps(reply).encode())
        elif ftype == T_RLEASE:
            msg = self._json(payload) if payload else {}
            if self._replicas is None:
                reply = {"status": "error",
                         "error": "no replica registry wired on this gateway"}
            else:
                try:
                    reply = self._replicas.handle_lease(msg)
                except Exception as e:  # noqa: BLE001
                    reply = {"status": "error",
                             "error": f"registry failed: {e!r}"}
            _send_frame(conn, T_RLEASE, json.dumps(reply).encode())
        elif ftype == T_RGRAD:
            # blocks this serve thread until the round completes or
            # fences; the registry bounds the wait
            _send_frame(conn, T_RGRAD,
                        _pack_round_reply(RSTAT_NOREG)
                        if self._replicas is None
                        else self._replicas.handle_round(payload))
        elif ftype == T_RPRIO:
            if self._replicas is None:
                reply = {"status": "error",
                         "error": "no replica registry wired on this gateway"}
            else:
                reply = self._replicas.handle_prio(payload)
            _send_frame(conn, T_RPRIO, json.dumps(reply).encode())
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
            # the standby's pull of the journal past its applied offset
            msg = self._json(payload) if payload else {}
            if (not self._ha or self._journal is None
                    or not self._serving or self._term_fenced):
                reply = {"error": "no HA journal serving on this gateway"}
            else:
                base, recs = self._journal.records_since(
                    int(msg.get("since", 0)))
                reply = {"term": self.term, "seq": self._journal.seq,
                         "base_seq": base, "records": recs,
                         "wall": time.time()}
            self.sync_served += 1
            _send_frame(conn, T_SYNC, json.dumps(reply).encode())

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
        if self._ha:
            self._ha_note_state()

    def _serve(self, conn: socket.socket, addr) -> None:
        slot: Optional[int] = None
        if self._idle_deadline and self._idle_deadline > 0:
            conn.settimeout(self._idle_deadline)
        try:
            with conn:
                while not self._stop.is_set():
                    ftype, payload = _recv_frame(conn)
                    if self._ha:
                        # before any side effect: an unpromoted standby
                        # or a fenced stale-term gateway refuses
                        # session verbs
                        self._session_gate(ftype)
                    if ftype not in _SESSIONLESS:
                        # a probe must not shift a drill's frame schedule
                        payload = self._faults.frame(payload)
                    if slot is not None:
                        self._last_seen[slot] = time.monotonic()
                    if ftype == T_BYE:
                        return
                    if ftype in _SESSIONLESS:
                        self._serve_sessionless(conn, ftype, payload)
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
                        if self._ha:
                            self._ha_note_state()
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
                        if self._ha and ind is not None:
                            # the absolute incarnation: idempotent, and
                            # the standby fences stale ones after a
                            # failover
                            self._ha_append("slot", {"slot": ind, "inc": inc})
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
        if self._ha_thread is not None:
            self._ha_thread.join(max(2.0, self._gp.sync_s * 4))
        if self._journal is not None:
            self._journal.close()
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

def fetch_profile(address: Tuple[str, int], seconds: float = 3.0,
                  label: Optional[str] = None, role: str = "learner",
                  timeout: Optional[float] = None) -> dict:
    """One T_PROFILE round-trip: trigger a bounded torch profiler window
    on the learner host and return the reply ({"trace_dir", "seconds"}
    on success, {"error": ...} otherwise).  Sessionless like
    ``fetch_status`` — no HELLO, no slot claim — and sits OUTSIDE the
    fault-injection plane, so profiling a drilled fleet never shifts
    the drill schedule.  The reply wait covers the window plus generous
    slack: the process's FIRST-ever profiler session pays a one-time
    init that can exceed a minute on a saturated small host
    (utils/perf.prewarm_profiler amortizes it at fleet startup when
    the perf plane is enabled, but a bare fleet stays cold until the
    first request).  The server clamps ``seconds``
    (PerfParams.profile_window_max), so a typo'd duration errs on the
    reply arriving early, not never."""
    if timeout is None:
        timeout = float(seconds) + 180.0
    msg: Dict[str, Any] = {"seconds": float(seconds), "role": role}
    if label is not None:
        msg["label"] = str(label)
    # retry only covers the connect phase: once the request is on the
    # wire the server may already hold the one-window profiler lock, and
    # a blind retry would answer "profiler busy" instead of the result
    return _sessionless_rpc(address, T_PROFILE, json.dumps(msg).encode(),
                            timeout, "T_PROFILE", retry_after_send=False)


def push_metrics(address: Tuple[str, int], rows: list,
                 offset: Optional[float] = None,
                 host: Optional[str] = None,
                 timeout: float = 10.0) -> dict:
    """One T_METRICS round-trip: push a batch of scalar rows (the
    MetricsWriter JSONL schema — plain dicts) into the learner-host
    aggregator.  Sessionless like ``fetch_status`` — no HELLO, no slot
    claim — and OUTSIDE the fault-injection plane, so the telemetry
    path never shifts a drill schedule.  ``offset`` is the pusher's
    estimated clock offset to the gateway (seconds to ADD to this
    host's walls); the reply carries ``accepted`` and the gateway's
    ``wall`` for the next offset estimate
    (utils/telemetry.MetricsPusher owns the estimator and cadence)."""
    msg: Dict[str, Any] = {"rows": list(rows)}
    if offset is not None:
        msg["offset"] = float(offset)
    if host is not None:
        msg["host"] = str(host)
    # full single-retry: re-pushing the same rows is at worst a
    # duplicate scalar sample on the same wall clock, and the pusher's
    # own catch-up window already tolerates that; wedging the stats
    # thread on a half-dead gateway is the failure that matters
    return _sessionless_rpc(address, T_METRICS, json.dumps(msg).encode(),
                            timeout, "T_METRICS")


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
