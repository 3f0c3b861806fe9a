"""The port's DCN wire (pytorch_distributed_tpu_torch/parallel/dcn.py)
against the JAX package's (pytorch_distributed_tpu/parallel/dcn.py).

- The chunk codec both ways: each package decodes what the other
  encodes.  ``np.savez`` bytes carry zip timestamps, so decoded columns
  are compared, to the bit.
- The bytes that are fixed are equal: frame headers, the JSON control
  frames each client sends (HELLO, TICK), GETP, PING and BYE, and the
  gateways' ``T_PARAMS`` replies (raw fp32).  ``T_CLOCK`` replies carry
  the gateway's wall clock: equal but for ``wall``.
- The port's gateway and client round trips, as tests/test_dcn.py's
  ``TestGateway`` and ``TestSlotLifecycle``.
- ``T_PROFILE`` and ``T_METRICS`` with a profiler and a metrics sink
  wired: the same replies, provider calls and counters, and each
  package's ``fetch_profile`` and ``push_metrics`` against each gateway.
- Cross-wire over 127.0.0.1: the JAX package's ``DcnClient`` against the
  port's ``DcnGateway`` and the reverse, through HELLO, EXP, GETP, TICK,
  PING, STATUS and BYE, with the same replies (credits, learner step,
  stop, parameter version and bytes).

Inputs come from one numpy generator (seed 0); every gateway binds
127.0.0.1 on port 0.
"""

import json
import socket
import struct
import threading
import time

import numpy as np
import pytest

from pytorch_distributed_tpu.agents import clocks as jax_clocks
from pytorch_distributed_tpu.agents import param_store as jax_ps
from pytorch_distributed_tpu.parallel import dcn as jax_dcn
from pytorch_distributed_tpu.utils import experience as jax_exp
from pytorch_distributed_tpu.utils import tracing as jax_tracing
from pytorch_distributed_tpu_torch.agents.clocks import ActorStats, GlobalClock
from pytorch_distributed_tpu_torch.agents.param_store import ParamStore
from pytorch_distributed_tpu_torch.parallel import dcn
from pytorch_distributed_tpu_torch.utils import experience, tracing
from pytorch_distributed_tpu_torch.utils.experience import Transition

LOCAL = "127.0.0.1"


def _rows(pkg_exp, n, shape=(4,), dtype=np.float32, seed=0, prov=True):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if dtype == np.uint8:
            s0 = rng.integers(0, 256, shape, dtype=np.uint8)
            s1 = rng.integers(0, 256, shape, dtype=np.uint8)
        else:
            s0 = rng.standard_normal(shape).astype(np.float32)
            s1 = rng.standard_normal(shape).astype(np.float32)
        t = pkg_exp.Transition(
            state0=s0, action=np.int32(rng.integers(0, 6)),
            reward=np.float32(rng.standard_normal()),
            gamma_n=np.float32(0.99 ** (i % 3 + 1)), state1=s1,
            terminal1=np.float32(i % 2))
        if prov and i % 3:
            t = t._replace(prov=pkg_exp.make_prov(i, i % 2, 7, 100 + i))
        p = None if i % 2 else float(rng.random())
        out.append((t, p))
    return out


def _same_items(a, b):
    assert len(a) == len(b)
    for (t0, p0), (t1, p1) in zip(a, b):
        for f in experience.REPLAY_FIELDS:
            x, y = np.asarray(getattr(t0, f)), np.asarray(getattr(t1, f))
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()
        pa, pb = getattr(t0, "prov", None), getattr(t1, "prov", None)
        assert (pa is None) == (pb is None)
        if pa is not None:
            assert np.array_equal(pa, pb) and pa.dtype == pb.dtype
        assert (p0 is None) == (p1 is None)
        if p0 is not None:
            assert np.float32(p0) == np.float32(p1)


# -- the codec ------------------------------------------------------------------

@pytest.mark.parametrize("dtype,shape", [(np.float32, (4,)),
                                         (np.uint8, (4, 6, 6))])
@pytest.mark.parametrize("traced", [False, True])
def test_the_codec_round_trips_across_packages(dtype, shape, traced):
    port_items = _rows(experience, 6, shape, dtype)
    jax_items = _rows(jax_exp, 6, shape, dtype)
    if traced:
        port_items = tracing.TracedChunk(port_items, trace_id=12345,
                                         born=1.5e9)
        jax_items = jax_tracing.TracedChunk(jax_items, trace_id=12345,
                                            born=1.5e9)
    for enc, dec, items in ((dcn.encode_chunk, jax_dcn.decode_chunk,
                             port_items),
                            (jax_dcn.encode_chunk, dcn.decode_chunk,
                             jax_items),
                            (dcn.encode_chunk, dcn.decode_chunk,
                             port_items)):
        out = dec(enc(items))
        _same_items(items, out)
        assert (getattr(out, "trace_id", None)
                == (12345 if traced else None))
        if traced:
            assert out.born == 1.5e9
    # the same columns, names and dtypes, from either encoder
    with np.load(__import__("io").BytesIO(dcn.encode_chunk(port_items))) \
            as a, np.load(__import__("io").BytesIO(
                jax_dcn.encode_chunk(jax_items))) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()
    assert dcn.WIRE_COLUMNS == jax_dcn.WIRE_COLUMNS


def test_malformed_and_corrupt_chunks_raise_as_the_reference():
    good = dcn.encode_chunk(_rows(experience, 3))
    for mod in (dcn, jax_dcn):
        with pytest.raises(ConnectionError):
            mod.decode_chunk(b"\xff" + good[1:])
    io = __import__("io")
    out = io.BytesIO()
    np.savez(out, state0=np.zeros((2, 4), np.float32))  # columns missing
    for mod in (dcn, jax_dcn):
        with pytest.raises(ValueError, match="missing columns"):
            mod.decode_chunk(out.getvalue())


def test_frame_header_and_verbs_match():
    assert dcn._HDR.format == jax_dcn._HDR.format
    assert dcn._HDR.pack(dcn.T_EXP, 12345) == \
        jax_dcn._HDR.pack(jax_dcn.T_EXP, 12345)
    names = ("T_HELLO T_EXP T_GETP T_PARAMS T_CLOCK T_TICK T_BYE T_PING "
             "T_STATUS T_PROFILE T_METRICS T_RLEASE T_RGRAD T_RPRIO T_SYNC "
             "T_SSAMPLE T_SMASS T_SPRIO").split()
    for n in names:
        assert getattr(dcn, n) == getattr(jax_dcn, n), n
    assert dcn._MAX_FRAME == jax_dcn._MAX_FRAME
    assert dcn._pack_noshard_reply() and dcn.RSTAT_NOREG == jax_dcn.RSTAT_NOREG
    assert (jax_dcn._unpack_round_reply(dcn._pack_round_reply(4))
            == {**jax_dcn._unpack_round_reply(
                jax_dcn._pack_round_reply(4)), "grad": None})
    for spec in ("h:1,g:2", "5555", [("a", 1), "b:2"], ("x", 9), ""):
        assert dcn.parse_endpoints(spec) == jax_dcn.parse_endpoints(spec)


# -- the client's bytes: one recording server per package ------------------------

class _Recorder:
    """Accepts one connection, records every frame, answers each with a
    fixed T_CLOCK (T_PARAMS version 0 for GETP) until BYE."""

    CLOCK = json.dumps({"learner_step": 5, "stop": False}).encode()

    def __init__(self):
        self.srv = socket.create_server((LOCAL, 0))
        self.port = self.srv.getsockname()[1]
        self.frames = []
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        conn, _ = self.srv.accept()
        with conn:
            while True:
                hdr = dcn._recv_exact(conn, 9)
                ftype, n = struct.unpack("!BQ", hdr)
                payload = dcn._recv_exact(conn, n) if n else b""
                self.frames.append((hdr, ftype, payload))
                if ftype == dcn.T_BYE:
                    return
                if ftype == dcn.T_GETP:
                    conn.sendall(struct.pack("!BQ", dcn.T_PARAMS, 8)
                                 + struct.pack("!Q", 0))
                else:
                    conn.sendall(struct.pack("!BQ", dcn.T_CLOCK,
                                             len(self.CLOCK)) + self.CLOCK)


def _drive_client(mod, exp_mod):
    rec = _Recorder()
    c = mod.DcnClient((LOCAL, rec.port), process_ind=3, incarnation=42,
                      heartbeat_interval=0)
    c._tick_seq = 1000
    c.tick(actor_steps=7, stats={"nepisodes": 1.0, "total_reward": 2.5})
    assert c.get_params(0) is None
    c.ping()
    c.send_chunk(_rows(exp_mod, 4))
    c.close()
    rec.thread.join(5)
    rec.srv.close()
    assert c.learner_step == 5 and not c.stop.is_set()
    return rec.frames


def test_the_clients_send_the_reference_bytes():
    port_frames = _drive_client(dcn, experience)
    jax_frames = _drive_client(jax_dcn, jax_exp)
    assert [f[1] for f in port_frames] == [f[1] for f in jax_frames] == [
        dcn.T_HELLO, dcn.T_TICK, dcn.T_GETP, dcn.T_PING, dcn.T_EXP,
        dcn.T_BYE]
    for (h0, ft, p0), (h1, _ft, p1) in zip(port_frames, jax_frames):
        if ft == dcn.T_EXP:  # savez: equal columns, equal length
            _same_items(dcn.decode_chunk(p0), jax_dcn.decode_chunk(p1))
            assert len(p0) == len(p1) and h0 == h1
        else:
            assert (h0, p0) == (h1, p1), ft


# -- the gateways' replies to the same raw frames --------------------------------

def _raw_rpc(sock, ftype, payload=b""):
    dcn._send_frame(sock, ftype, payload)
    return dcn._recv_frame(sock)


def _gateway(mod, store, clock, stats, sink, **kw):
    return mod.DcnGateway(store, clock, stats, put_chunk=sink, host=LOCAL,
                          port=0, **kw)


def test_the_gateways_answer_the_same_raw_frames():
    flat = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    replies = {}
    for name, mod, ps, ck in (("port", dcn, ParamStore, GlobalClock),
                              ("jax", jax_dcn, jax_ps.ParamStore,
                               jax_clocks.GlobalClock)):
        store, clock = ps(64), ck()
        stats = (ActorStats if name == "port" else jax_clocks.ActorStats)()
        store.publish(flat)
        clock.set_learner_step(17)
        got = []
        gw = _gateway(mod, store, clock, stats, got.append)
        try:
            s = socket.create_connection((LOCAL, gw.port))
            out = []
            hello = json.dumps({"role": "actor", "process_ind": 2,
                                "incarnation": 9}).encode()
            for ft, pl in ((dcn.T_HELLO, hello),
                           (dcn.T_GETP, struct.pack("!Q", 0)),
                           (dcn.T_GETP, struct.pack("!Q", 1)),
                           (dcn.T_TICK, json.dumps(
                               {"actor_steps": 4, "seq": 1}).encode()),
                           (dcn.T_PING, b""),
                           (dcn.T_EXP, dcn.encode_chunk(
                               _rows(experience, 3))),
                           (dcn.T_PROFILE, b""), (dcn.T_RLEASE, b"{}"),
                           (dcn.T_RGRAD, b""), (dcn.T_RPRIO, b""),
                           (dcn.T_SSAMPLE, b""), (dcn.T_SMASS, b"{}"),
                           (dcn.T_SPRIO, b""), (dcn.T_SYNC, b"{}"),
                           (dcn.T_METRICS, b"{}")):
                out.append(_raw_rpc(s, ft, pl))
            dcn._send_frame(s, dcn.T_BYE, b"")
            s.close()
            assert clock.actor_step.value == 4
            assert len(got) == 1 and len(got[0]) == 3
        finally:
            gw.close()
        replies[name] = out
    for (ta, pa), (tb, pb) in zip(replies["port"], replies["jax"]):
        assert ta == tb
        if ta in (dcn.T_CLOCK, dcn.T_METRICS):
            ja, jb = json.loads(pa), json.loads(pb)
            assert ja.pop("wall") > 0 and jb.pop("wall") > 0
            assert ja == jb
        elif ta in (dcn.T_RGRAD, dcn.T_SSAMPLE):
            with np.load(__import__("io").BytesIO(pa)) as za, \
                    np.load(__import__("io").BytesIO(pb)) as zb:
                assert sorted(za.files) == sorted(zb.files)
                for k in za.files:
                    assert np.array_equal(za[k], zb[k])
        else:  # T_PARAMS and the JSON error replies: the same bytes
            assert pa == pb, ta
    # the fp32 parameters ride as raw bytes after the !Q version
    t, p = replies["port"][1]
    assert t == dcn.T_PARAMS and struct.unpack("!Q", p[:8])[0] == 1
    assert p[8:] == flat.tobytes()
    assert replies["port"][2][1] == struct.pack("!Q", 0)


# -- round trips on the port, as tests/test_dcn.py ---------------------------------

def _t(i, shape=(4,)):
    return Transition(
        state0=np.full(shape, i, dtype=np.float32), action=np.int32(i % 3),
        reward=np.float32(0.5 * i), gamma_n=np.float32(0.99),
        state1=np.full(shape, i + 1, dtype=np.float32),
        terminal1=np.float32(i % 2))


@pytest.fixture()
def gateway():
    clock, stats, store, chunks = GlobalClock(), ActorStats(), \
        ParamStore(16), []
    gw = _gateway(dcn, store, clock, stats, chunks.append)
    yield gw, store, clock, stats, chunks
    gw.close()


class TestGateway:
    def test_experience_flows_to_put_chunk(self, gateway):
        gw, _store, _clock, _stats, chunks = gateway
        client = dcn.DcnClient((LOCAL, gw.port))
        mem = dcn.RemoteMemory(client, chunk=3)
        for i in range(7):
            mem.feed(_t(i))
        mem.flush()
        client.close()
        deadline = time.monotonic() + 5
        while sum(len(c) for c in chunks) < 7:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        got = [t for c in chunks for t, _ in c]
        np.testing.assert_array_equal(got[4].state0,
                                      np.full((4,), 4, dtype=np.float32))
        # the feeder's chunks are traced, and the trace crosses the wire
        assert all(isinstance(c, tracing.TracedChunk) for c in chunks)

    def test_param_fetch_versions(self, gateway):
        gw, store, _clock, _stats, _chunks = gateway
        client = dcn.DcnClient((LOCAL, gw.port))
        ps = dcn.RemoteParamStore(client)
        assert ps.fetch(0) is None
        flat0 = np.arange(16, dtype=np.float32)
        store.publish(flat0)
        flat, version = ps.wait(0, timeout=5)
        assert version == 1
        np.testing.assert_array_equal(flat, flat0)
        assert ps.fetch(version) is None
        store.publish(flat0 * 2)
        flat2, v2 = ps.fetch(version)
        assert v2 == 2
        np.testing.assert_array_equal(flat2, flat0 * 2)
        client.close()

    def test_clock_and_stats_aggregate(self, gateway):
        gw, _store, clock, stats, _chunks = gateway
        client = dcn.DcnClient((LOCAL, gw.port))
        rclock = dcn.RemoteClock(client, flush_every=4)
        rstats = dcn.RemoteStats(client)
        for _ in range(9):
            rclock.add_actor_steps(1)
        rclock.flush()
        assert clock.actor_step.value == 9
        rstats.add(nepisodes=2, total_reward=5.0)
        drained = stats.drain()
        assert drained["nepisodes"] == 2
        assert drained["total_reward"] == pytest.approx(5.0)
        clock.set_learner_step(123)
        rclock.flush()
        assert rclock.learner_step.value == 123
        assert rclock.done(steps=100)
        assert not client.stop.is_set()
        clock.stop.set()
        rclock.flush()
        assert client.stop.is_set()
        client.close()

    def test_client_disconnects_on_gateway_death(self, gateway):
        gw, _store, _clock, _stats, _chunks = gateway
        client = dcn.DcnClient((LOCAL, gw.port), heartbeat_interval=0,
                               reconnect_timeout=1.0)
        rclock = dcn.RemoteClock(client, flush_every=1)
        gw.close()
        deadline = time.monotonic() + 30
        while not client.disconnected.is_set():
            rclock.add_actor_steps(1)
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert not client.stop.is_set()
        assert rclock.done(steps=10 ** 9)
        assert rclock._pending >= 1


class TestSlotLifecycle:
    def test_slot_freed_on_disconnect_then_reclaimable(self, gateway):
        gw, *_ = gateway
        c1 = dcn.DcnClient((LOCAL, gw.port), process_ind=5,
                           heartbeat_interval=0)
        assert gw.active_slots == {5: c1.incarnation}
        c1.close()
        deadline = time.monotonic() + 5
        while gw.active_slots:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        c2 = dcn.DcnClient((LOCAL, gw.port), process_ind=5,
                           heartbeat_interval=0)
        assert gw.active_slots == {5: c2.incarnation}
        c2.close()

    def test_hello_conflict_on_live_duplicate(self, gateway):
        gw, *_ = gateway
        c1 = dcn.DcnClient((LOCAL, gw.port), process_ind=3,
                           incarnation=200, heartbeat_interval=0)
        with pytest.raises(dcn.DcnRefused, match="already connected"):
            dcn.DcnClient((LOCAL, gw.port), process_ind=3,
                          incarnation=200, heartbeat_interval=0)
        assert gw.active_slots == {3: 200}
        assert gw.fenced == 0
        c1.tick(actor_steps=1)
        c1.close()

    def test_fencing_evicts_lower_incarnation_predecessor(self, gateway):
        gw, *_ = gateway
        a = dcn.DcnClient((LOCAL, gw.port), process_ind=3, incarnation=100,
                          heartbeat_interval=0, reconnect_timeout=1.0)
        b = dcn.DcnClient((LOCAL, gw.port), process_ind=3, incarnation=200,
                          heartbeat_interval=0)
        assert gw.fenced == 1
        assert gw.active_slots == {3: 200}
        b.tick(actor_steps=1)
        with pytest.raises(ConnectionError):
            a.tick(actor_steps=1)
        assert a.disconnected.is_set() and not a.stop.is_set()
        a.close()
        time.sleep(0.2)
        assert gw.active_slots == {3: 200}
        b.close()

    def test_local_slot_refused(self):
        gw = _gateway(dcn, ParamStore(16), GlobalClock(), ActorStats(),
                      lambda items: None, local_actors=2)
        try:
            with pytest.raises(RuntimeError,
                               match="local to the learner host"):
                dcn.DcnClient((LOCAL, gw.port), process_ind=1,
                              heartbeat_interval=0)
        finally:
            gw.close()


# -- cross-wire: each package's client against the other's gateway ---------------

def _cross(client_mod, client_exp, gw_mod, store, clock, stats):
    flat = np.random.default_rng(1).standard_normal(32).astype(np.float32)
    chunks = []
    gw = _gateway(gw_mod, store, clock, stats, chunks.append)
    try:
        client = client_mod.DcnClient((LOCAL, gw.port), process_ind=4,
                                      heartbeat_interval=0)
        assert gw.active_slots == {4: client.incarnation}
        assert client.credits is None  # healthy: no credit field
        assert client.get_params(0) is None
        store.publish(flat)
        got, version = client.get_params(0)
        assert version == 1 and got.tobytes() == flat.tobytes()
        items = _rows(client_exp, 5, shape=(3, 5, 5), dtype=np.uint8)
        client.send_chunk(items)
        clock.set_learner_step(11)
        assert client.tick(actor_steps=6,
                           stats={"nepisodes": 1.0}) == 11
        assert clock.actor_step.value == 6
        assert stats.drain()["nepisodes"] == 1.0
        clock.set_learner_step(12)
        assert client.ping() == 12
        status = client_mod.fetch_status((LOCAL, gw.port))
        assert status["slots"]["4"]["incarnation"] == client.incarnation
        assert status["chunks_in"] == 1 and status["learner_step"] == 12
        assert status["flow"]["state"] == "healthy"
        assert status["flow"]["conservation"]["ingested"] == 5
        clock.stop.set()
        client.tick()
        assert client.stop.is_set() and not client.disconnected.is_set()
        client.close()
        deadline = time.monotonic() + 5
        while gw.active_slots:  # BYE frees the slot
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert len(chunks) == 1
        _same_items(items, chunks[0])
        assert isinstance(chunks[0], list)
    finally:
        gw.close()


def test_the_jax_client_against_the_port_gateway():
    _cross(jax_dcn, jax_exp, dcn, ParamStore(32), GlobalClock(),
           ActorStats())


def test_the_port_client_against_the_jax_gateway():
    _cross(dcn, experience, jax_dcn, jax_ps.ParamStore(32),
           jax_clocks.GlobalClock(), jax_clocks.ActorStats())


def test_feed_queue_of_a_slot_ingest_carries_bare_rows():
    from pytorch_distributed_tpu_torch.memory.device_replay import (
        DeviceReplayIngest,
    )

    ingest = DeviceReplayIngest(64, (4,), state_dtype=np.float32,
                                in_process=False, slots=2)
    put = dcn.feed_queue_of(type("H", (), {"learner_side": ingest})())
    items = tracing.TracedChunk(_rows(experience, 3, prov=False),
                                trace_id=5, born=1.0)
    put(items)
    assert ingest.queue_depth() == 1
    rows, popped = ingest.read()
    assert popped == 3 and all(isinstance(r, Transition) for r in rows)
    ingest.close()
    with pytest.raises(ValueError):
        put(items)


# -- the telemetry verbs with their providers wired ---------------------------------

def test_the_telemetry_verbs_with_providers_answer_as_the_reference():
    """``T_PROFILE`` and ``T_METRICS`` on gateways whose ``profiler`` and
    ``metrics_sink`` are wired (a provider that answers, one that raises,
    a sink that counts rows): the same replies but for the wall clock,
    the same messages handed to the providers, and the same STATUS
    counters; ``fetch_profile`` and ``push_metrics`` of each package
    against each gateway."""
    replies, seen, counts = {}, {}, {}
    for name, mod, ps, ck in (("port", dcn, ParamStore, GlobalClock),
                              ("jax", jax_dcn, jax_ps.ParamStore,
                               jax_clocks.GlobalClock)):
        calls = seen[name] = []

        def profiler(msg, calls=calls):
            calls.append(("profile", msg))
            if msg.get("label") == "boom":
                raise RuntimeError("no window")
            return {"trace_dir": f"/traces/{msg.get('label')}",
                    "seconds": msg.get("seconds")}

        def sink(batch, calls=calls):
            calls.append(("metrics", batch))
            return len(batch.get("rows", []))

        stats = (ActorStats if name == "port" else jax_clocks.ActorStats)()
        gw = mod.DcnGateway(ps(4), ck(), stats, put_chunk=lambda items: None,
                            host=LOCAL, port=0, profiler=profiler,
                            metrics_sink=sink)
        try:
            out = []
            s = socket.create_connection((LOCAL, gw.port))
            for ft, msg in ((dcn.T_PROFILE, {"seconds": 0.5, "label": "a",
                                              "role": "learner"}),
                            (dcn.T_PROFILE, {"label": "boom"}),
                            (dcn.T_METRICS, {"rows": [{"tag": "t",
                                                       "value": 1.0}],
                                             "offset": 0.25, "host": "h"}),
                            (dcn.T_METRICS, {})):
                t, p = _raw_rpc(s, ft, json.dumps(msg).encode())
                reply = json.loads(p)
                reply.pop("wall", None)
                out.append((t, reply))
            dcn._send_frame(s, dcn.T_BYE, b"")
            s.close()
            addr = (LOCAL, gw.port)
            for helper in (dcn, jax_dcn):
                out.append(helper.fetch_profile(addr, seconds=0.25,
                                                label="h"))
                r = helper.push_metrics(addr, [{"tag": "u", "value": 2.0}],
                                        offset=1.0, host="x")
                assert r.pop("wall") > 0
                out.append(r)
            st = mod.fetch_status(addr)
            counts[name] = (st["metrics_batches"], st["metrics_rows"],
                            gw.profiles_served)
        finally:
            gw.close()
        replies[name] = out
    assert replies["port"] == replies["jax"]
    assert replies["port"][0] == (dcn.T_PROFILE, {"trace_dir": "/traces/a",
                                                  "seconds": 0.5})
    assert replies["port"][1][1]["error"].startswith("profiler failed")
    assert replies["port"][2] == (dcn.T_METRICS, {"accepted": 1})
    assert seen["port"] == seen["jax"]
    assert counts["port"] == counts["jax"] == (4, 3, 4)
