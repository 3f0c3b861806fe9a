"""The port's gateway HA plane (pytorch_distributed_tpu_torch/parallel/
dcn.py ``GatewayJournal``, the gateway's standby role, ``T_SYNC`` and the
client's endpoint list) in the drills of tests/test_gateway_ha.py: the
WAL round trip and its torn tail, a corrupt journal as a counted clean
slate, the record digest, the standby's idempotent applied copy, seeding
without double counting, the warm restart, failover with promotion,
fencing and resurrection, the leg with no standby, the plane off leaving
the wire as it was, and ``parse_endpoints``.

Across packages: a port standby pulls a JAX primary's journal over
``T_SYNC`` and promotes over it, and a JAX standby does the same from a
port primary; each package's ``GatewayJournal`` recovers the other's WAL
and reads the other's ``TERM.json``; the digests are the same strings.

Every gateway binds 127.0.0.1 on port 0, with a 0.4 s lease and a 0.05 s
sync cadence (the reference's drill values); the rows come from one
numpy generator (seed 0).  No tolerance: records, terms and counters are
compared exactly.
"""

import json
import os
import socket
import threading
import time

import numpy as np
import pytest

from pytorch_distributed_tpu.agents import clocks as jax_clocks
from pytorch_distributed_tpu.agents import param_store as jax_ps
from pytorch_distributed_tpu.config import GatewayParams as JaxGatewayParams
from pytorch_distributed_tpu.parallel import dcn as jax_dcn
from pytorch_distributed_tpu_torch.agents.clocks import ActorStats, GlobalClock
from pytorch_distributed_tpu_torch.agents.param_store import ParamStore
from pytorch_distributed_tpu_torch.config import GatewayParams
from pytorch_distributed_tpu_torch.parallel.dcn import (
    T_HELLO, DcnClient, DcnDisconnected, DcnGateway, GatewayJournal,
    _rec_digest, _recv_frame, _send_frame, fetch_status, parse_endpoints,
)
from pytorch_distributed_tpu_torch.utils.experience import Transition

GP = GatewayParams(enabled=True, lease_s=0.4, sync_s=0.05)
JGP = JaxGatewayParams(enabled=True, lease_s=0.4, sync_s=0.05)
LOCAL = "127.0.0.1"


class ChunkLog:
    """A gateway's ``put_chunk`` that keeps each row's tag (its reward)."""

    def __init__(self):
        self.tags = []
        self._lock = threading.Lock()

    def __call__(self, items):
        with self._lock:
            self.tags.extend(float(t.reward) for t, _p in items)


def tagged(i: int, pkg_transition=Transition) -> object:
    rng = np.random.default_rng(i)
    return pkg_transition(
        state0=rng.standard_normal(4).astype(np.float32),
        action=np.int32(i % 3), reward=np.float32(i),
        gamma_n=np.float32(0.99), state1=np.zeros(4, np.float32),
        terminal1=np.float32(0))


def make_gateway(tmp, log, role="primary", sync_from=None,
                 resume_term=None, gp=GP):
    store = ParamStore(8)
    store.publish(np.zeros(8, dtype=np.float32))
    return DcnGateway(store, GlobalClock(), ActorStats(), put_chunk=log,
                      host=LOCAL, port=0, idle_deadline=30.0,
                      gateway_params=gp, log_dir=str(tmp), ha_role=role,
                      sync_from=sync_from, resume_term=resume_term)


def make_jax_gateway(tmp, log, role="primary", sync_from=None):
    store = jax_ps.ParamStore(8)
    store.publish(np.zeros(8, dtype=np.float32))
    return jax_dcn.DcnGateway(
        store, jax_clocks.GlobalClock(), jax_clocks.ActorStats(),
        put_chunk=log, host=LOCAL, port=0, idle_deadline=30.0,
        gateway_params=JGP, log_dir=str(tmp), ha_role=role,
        sync_from=sync_from)


def _hello(addr, slot=7, inc=None):
    """A raw HELLO: the reply, or None when the gateway dropped the
    connection (the standby's and the fenced gateway's refusal)."""
    sock = socket.create_connection(addr, timeout=2.0)
    try:
        sock.settimeout(2.0)
        _send_frame(sock, T_HELLO, json.dumps(
            {"process_ind": slot,
             "incarnation": inc or time.time_ns()}).encode())
        try:
            _ftype, payload = _recv_frame(sock)
        except (ConnectionError, OSError):
            return None
        return json.loads(payload.decode())
    finally:
        sock.close()


def _wait(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


# -- the WAL's edges -----------------------------------------------------------

def test_wal_roundtrip_and_torn_tail(tmp_path):
    j = GatewayJournal(str(tmp_path))
    j.write_term(3)
    j.start_term(3)
    for i in range(5):
        j.append("slot", {"slot": i, "inc": 100 + i})
    path = j._wal_path(3)
    j.close()
    with open(path, "ab") as f:  # a torn write: half a record
        f.write(b'{"seq": 99, "kind": "slot", "da')
    j2 = GatewayJournal(str(tmp_path))
    term, recs = j2.recover()
    assert term == 3
    assert [r["data"]["slot"] for r in recs] == [0, 1, 2, 3, 4]
    assert j2.recover_warnings >= 1
    assert j2.read_term() == 3
    j2.close()


def test_wal_corrupt_is_counted_clean_slate(tmp_path):
    gwdir = tmp_path / "gateway"
    os.makedirs(gwdir)
    (gwdir / "TERM.json").write_text("{not json")
    (gwdir / "wal-00000007.jsonl").write_text("complete garbage\n\x00\x01")
    j = GatewayJournal(str(tmp_path))
    assert j.read_term() == 0
    term, recs = j.recover()
    assert term == 7  # the term's floor survives an unreadable file
    assert recs == []
    assert j.recover_warnings >= 1
    j.close()


def test_wal_record_digest_rejects_tamper(tmp_path):
    j = GatewayJournal(str(tmp_path))
    j.write_term(1)
    j.start_term(1)
    j.append("slot", {"slot": 0, "inc": 5})
    j.append("slot", {"slot": 1, "inc": 6})
    path = j._wal_path(1)
    j.close()
    lines = open(path).read().splitlines()
    lines[0] = lines[0].replace('"inc": 5', '"inc": 500')
    open(path, "w").write("\n".join(lines) + "\n")
    j2 = GatewayJournal(str(tmp_path))
    _term, recs = j2.recover()
    assert [r["data"]["slot"] for r in recs] == [1]
    assert j2.recover_warnings >= 1
    j2.close()


def test_standby_applied_copy_is_idempotent(tmp_path):
    j = GatewayJournal(str(tmp_path), standby=True)
    recs = [{"seq": i, "kind": "slot", "data": {"slot": 0, "inc": i},
             "sha": _rec_digest(i, "slot", {"slot": 0, "inc": i})}
            for i in range(1, 6)]
    for r in recs:
        assert j.apply(r) is True
    j.close()
    j2 = GatewayJournal(str(tmp_path), standby=True)
    _t, seen = j2.recover()
    assert len(seen) == 5 and j2.seq == 5
    assert all(j2.apply(r) is False for r in recs[2:])
    assert j2.seq == 5
    j2.close()


def test_seed_records_double_apply_no_double_count(tmp_path):
    gw = make_gateway(tmp_path, ChunkLog())
    try:
        recs = [{"seq": 1, "kind": "state",
                 "data": {"tick_seq": {"0": 7}, "chunks_in": 40, "lost": 3,
                          "ledger": {"ingested": 100, "shed": 2,
                                     "quarantined": 1}}},
                {"seq": 2, "kind": "slot", "data": {"slot": 0, "inc": 9}}]
        gw._seed_records(recs)
        first = dict(gw._ha_carry)
        gw._seed_records(recs)  # the replay is a no-op
        assert gw._ha_carry == first
        assert gw.failover_lost == 3
        assert gw._ha_carry["ingested"] == 100
        assert gw._inc_floor[0] == 9
    finally:
        gw.close()


def test_warm_restart_continues_term_and_ledger(tmp_path):
    log = ChunkLog()
    gw = make_gateway(tmp_path, log)
    t1 = gw.term
    gw._ha_append("state", {"tick_seq": {}, "chunks_in": 11, "lost": 0,
                            "ledger": {"ingested": 22, "shed": 0,
                                       "quarantined": 0}})
    gw.close()
    gw2 = make_gateway(tmp_path, log)
    try:
        assert gw2.term == t1 + 1
        snap = gw2.status_snapshot()["gateway"]
        assert snap["carry"]["chunks_in"] == 11
        assert snap["carry"]["ingested"] == 22
    finally:
        gw2.close()


# -- failover: promotion, the client's failover, fenced resurrection -----------

@pytest.mark.timeout(60)
def test_failover_promotion_fencing_and_resurrection(tmp_path):
    log = ChunkLog()
    primary = make_gateway(tmp_path, log)
    old_term = primary.term
    standby = make_gateway(tmp_path, log, role="standby",
                           sync_from=(LOCAL, primary.port))
    client = DcnClient([(LOCAL, primary.port), (LOCAL, standby.port)],
                       process_ind=0, reconnect_timeout=10.0,
                       heartbeat_interval=0.2)
    try:
        assert _hello((LOCAL, standby.port)) is None  # refused
        assert standby.standby_refused >= 1
        for i in range(5):
            client.send_chunk([(tagged(i), None)])
        _wait(lambda: primary.status_snapshot()["gateway"]["journal_seq"]
              >= 2, 3.0, "the journal")
        primary.close()
        assert standby.promoted.wait(GP.lease_s * 4 + 2.0)
        for i in range(5, 10):
            client.send_chunk([(tagged(i), None)])
        _wait(lambda: set(log.tags) >= set(map(float, range(10))), 8.0,
              "every row")
        assert client.failovers == 1
        assert client.address == (LOCAL, standby.port)
        snap = standby.status_snapshot()["gateway"]
        assert (snap["role"], snap["term"], snap["promotions"]) == (
            "primary", old_term + 1, 1)
        # the journaled floor crossed the failover: a stale incarnation
        reply = _hello((LOCAL, standby.port), slot=0, inc=1)
        assert reply is None or reply.get("error")
        # the old primary back on its stale term: refused, counted, and
        # nothing applied
        zsink = ChunkLog()
        zombie = make_gateway(tmp_path, zsink, resume_term=old_term)
        try:
            assert _hello((LOCAL, zombie.port)) is None
            assert zombie.gateway_term_fenced >= 1
            assert zombie.chunks_in == 0 and zsink.tags == []
        finally:
            zombie.close()
    finally:
        client.close()
        standby.close()


@pytest.mark.timeout(60)
def test_no_standby_leg_exits_disconnected(tmp_path):
    gw = make_gateway(tmp_path, ChunkLog())
    client = DcnClient((LOCAL, gw.port), process_ind=0,
                       reconnect_timeout=1.0, heartbeat_interval=0.2)
    try:
        client.send_chunk([(tagged(0), None)])
        gw.close()
        with pytest.raises(DcnDisconnected):
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                client.send_chunk([(tagged(1), None)])
                time.sleep(0.05)
        assert client.disconnected.is_set()
    finally:
        client.close()


# -- the plane off: nothing new on the wire or on disk -------------------------

def _replies(gw_port):
    """The bytes a raw session gets back for a HELLO, a PING and a STATUS
    probe, the walls and the uptime dropped."""
    sock = socket.create_connection((LOCAL, gw_port), timeout=5.0)
    out = []
    try:
        for ftype, payload in ((T_HELLO, json.dumps(
                {"process_ind": 3, "incarnation": 5}).encode()),
                               (8, b"")):
            _send_frame(sock, ftype, payload)
            rtype, reply = _recv_frame(sock)
            msg = json.loads(reply.decode())
            msg.pop("wall")
            out.append((rtype, sorted(msg.items())))
    finally:
        sock.close()
    status = fetch_status((LOCAL, gw_port))
    return out, sorted(status)


def test_ha_disabled_is_byte_compatible(tmp_path):
    """The plane off (the default), with a log dir given: no STATUS block,
    no journal dir, a single-endpoint client, and the same replies and
    STATUS keys as a gateway built without the HA arguments."""
    store = ParamStore(8)
    store.publish(np.zeros(8, dtype=np.float32))
    gw = DcnGateway(store, GlobalClock(), ActorStats(),
                    put_chunk=lambda items: None, host=LOCAL, port=0,
                    log_dir=str(tmp_path))  # log_dir alone does not arm it
    plain = DcnGateway(store, GlobalClock(), ActorStats(),
                       put_chunk=lambda items: None, host=LOCAL, port=0)
    client = DcnClient((LOCAL, gw.port), process_ind=0)
    try:
        status = fetch_status((LOCAL, gw.port))
        assert "gateway" not in status
        assert not os.path.exists(tmp_path / "gateway")
        assert client.endpoints == [(LOCAL, gw.port)]
        assert client.failovers == 0
        client.send_chunk([(tagged(0), None)])
        assert _replies(gw.port)[0] == _replies(plain.port)[0]
        assert set(_replies(gw.port)[1]) == set(_replies(plain.port)[1])
    finally:
        client.close()
        gw.close()
        plain.close()


def test_parse_endpoints_forms():
    assert parse_endpoints(("h", 1)) == [("h", 1)]
    assert parse_endpoints([("a", 1), ("b", 2)]) == [("a", 1), ("b", 2)]
    assert parse_endpoints("a:1,b:2") == [("a", 1), ("b", 2)]
    assert parse_endpoints(["a:1", ("b", 2)]) == [("a", 1), ("b", 2)]
    assert parse_endpoints("") == []
    for spec in (("h", 1), "a:1,b:2", ["a:1", ("b", 2)], ""):
        assert parse_endpoints(spec) == jax_dcn.parse_endpoints(spec)


# -- across packages -------------------------------------------------------------

def test_digests_and_records_are_the_references(tmp_path):
    data = {"tick_seq": {"0": 7, "1": 3}, "chunks_in": 4,
            "ledger": {"shed": 0, "ingested": 12}}
    for seq, kind in ((1, "slot"), (17, "state"), (3, "term")):
        assert _rec_digest(seq, kind, data) == jax_dcn._rec_digest(
            seq, kind, data)
    port_j = GatewayJournal(str(tmp_path / "p"))
    jax_j = jax_dcn.GatewayJournal(str(tmp_path / "j"))
    for j in (port_j, jax_j):
        j.start_term(2)
        j.append("slot", {"slot": 1, "inc": 9})
        j.append("state", data)
        j.close()
    assert open(port_j._wal_path(2)).read() == open(
        jax_j._wal_path(2)).read()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_wal_and_term(tmp_path, writer):
    mk, rd = ((GatewayJournal, jax_dcn.GatewayJournal) if writer == "port"
              else (jax_dcn.GatewayJournal, GatewayJournal))
    w = mk(str(tmp_path))
    w.write_term(5)
    w.start_term(5)
    for i in range(4):
        w.append("slot", {"slot": i, "inc": 50 + i})
    w.close()
    with open(w._wal_path(5), "ab") as f:  # and a torn tail
        f.write(b'{"seq": 9, "ki')
    r = rd(str(tmp_path))
    assert r.read_term() == 5
    term, recs = r.recover()
    assert term == 5 and r.seq == 4
    assert [x["data"]["inc"] for x in recs] == [50, 51, 52, 53]
    assert r.recover_warnings == 1
    r.close()


@pytest.mark.timeout(60)
@pytest.mark.parametrize("primary_pkg", ["jax", "port"])
def test_a_standby_syncs_and_promotes_across_packages(tmp_path,
                                                      primary_pkg):
    """A JAX primary and a port standby over T_SYNC, and the reverse: the
    standby applies the primary's claims (its journaled floor fences a
    stale incarnation after the promotion) and promotes one term up on
    the shared TERM.json when the primary is gone."""
    log = ChunkLog()
    if primary_pkg == "jax":
        primary = make_jax_gateway(tmp_path, log)
        standby = make_gateway(tmp_path, log, role="standby",
                               sync_from=(LOCAL, primary.port))
        client = jax_dcn.DcnClient((LOCAL, primary.port), process_ind=2)
        row = lambda i: tagged(i, jax_dcn.Transition)
    else:
        primary = make_gateway(tmp_path, log)
        standby = make_jax_gateway(tmp_path, log, role="standby",
                                   sync_from=(LOCAL, primary.port))
        client = DcnClient((LOCAL, primary.port), process_ind=2)
        row = tagged
    try:
        old_term = primary.term
        for i in range(3):
            client.send_chunk([(row(i), None)])
        inc = client.incarnation
        _wait(lambda: standby._inc_floor.get(2) == inc
              and standby._sync_seq >= primary._journal.seq, 5.0,
              "the standby's copy")
        assert standby.status_snapshot()["gateway"]["role"] == "standby"
        client.close()
        primary.close()
        assert standby.promoted.wait(JGP.lease_s * 4 + 2.0)
        snap = standby.status_snapshot()["gateway"]
        assert (snap["role"], snap["term"]) == ("primary", old_term + 1)
        for rd in (GatewayJournal, jax_dcn.GatewayJournal):
            assert rd(str(tmp_path)).read_term() == old_term + 1
        stale = _hello((LOCAL, standby.port), slot=2, inc=inc)
        assert stale is None or "fenced" in stale.get("error", "")
        fresh = _hello((LOCAL, standby.port), slot=2, inc=inc + 1)
        assert fresh is not None and "error" not in fresh
        assert sorted(log.tags) == [0.0, 1.0, 2.0]
    finally:
        client.close()
        primary.close()
        standby.close()
