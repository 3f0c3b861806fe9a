"""The drills of tests/test_chaos.py on the port's session layer
(pytorch_distributed_tpu_torch/parallel/dcn.py with utils/faults.py): the
fault grammar and the ``random:SEED[:HORIZON]`` schedules against the
JAX package's, a gateway restart, a sever, a corrupt frame, a blackhole
that heals, the terminal loss, a poison frame, a crash, tick dedup, a
malformed HELLO, heartbeats and the idle reap, a fleet through a gateway
restart with no chunk lost, and the duplicate-slot race.  Deadlines are
the reference drills' own.  Every gateway binds 127.0.0.1 on port 0.
"""

import json
import socket
import threading
import time

import numpy as np
import pytest

from pytorch_distributed_tpu.utils import faults as jax_faults
from pytorch_distributed_tpu_torch.agents.clocks import ActorStats, GlobalClock
from pytorch_distributed_tpu_torch.agents.param_store import ParamStore
from pytorch_distributed_tpu_torch.parallel.dcn import (
    T_CLOCK, T_HELLO, T_TICK, DcnClient, DcnDisconnected, DcnGateway,
    RemoteClock, RemoteParamStore, RemoteStats, _recv_frame, _send_frame,
)
from pytorch_distributed_tpu_torch.utils.experience import Transition
from pytorch_distributed_tpu_torch.utils.faults import (
    FaultInjector, InjectedCrash, InjectedDisconnect, parse_faults,
)

LOCAL = "127.0.0.1"


def tagged_transition(tag: int) -> Transition:
    z = np.zeros(2, dtype=np.float32)
    return Transition(state0=z, action=np.int32(0),
                      reward=np.float32(tag), gamma_n=np.float32(0.99),
                      state1=z, terminal1=np.float32(0.0))


class ChunkLog:
    """``put_chunk`` sink recording each delivered row's tag."""

    def __init__(self):
        self._lock = threading.Lock()
        self.tags = []

    def __call__(self, items):
        with self._lock:
            self.tags.extend(int(t.reward) for t, _p in items)

    def seen(self):
        with self._lock:
            return set(self.tags)


class SyntheticActor:
    """Drives the client surfaces (chunks, ticks, stats, param fetches)
    with no env; records the tags the wire acknowledged and how the loop
    ended."""

    def __init__(self, address, slot, pace=0.0, client_kwargs=None):
        self.address, self.slot, self.pace = address, slot, pace
        self.client_kwargs = client_kwargs or {}
        self.client = None
        self.acked_tags = []
        self.step_regressions = 0
        self.outcome = None
        self.thread = None

    def start(self):
        self.thread = threading.Thread(target=self.run, daemon=True)
        self.thread.start()
        return self

    def run(self):
        self.client = client = DcnClient(self.address, process_ind=self.slot,
                                         **self.client_kwargs)
        rclock = RemoteClock(client, flush_every=16, max_age=0.5)
        rstats, rparams = RemoteStats(client), RemoteParamStore(client)
        i, last = 0, -1
        try:
            while not rclock.done(10 ** 9):
                tag = (self.slot << 20) | i
                client.send_chunk([(tagged_transition(tag), None)])
                self.acked_tags.append(tag)
                rclock.add_actor_steps(1)
                if i % 8 == 0:
                    rparams.fetch(0)
                if i % 16 == 0:
                    rstats.add(nepisodes=1.0, total_reward=1.0)
                if client.learner_step < last:
                    self.step_regressions += 1
                last = client.learner_step
                i += 1
                if self.pace:
                    time.sleep(self.pace)
        except (ConnectionError, OSError):
            pass
        try:
            rclock.flush()
        except (ConnectionError, OSError):
            pass
        client.close()
        self.outcome = ("disconnected" if client.disconnected.is_set()
                        and not client.stop.is_set() else "stopped")


@pytest.fixture()
def plane():
    clock, stats, store = GlobalClock(), ActorStats(), ParamStore(8)
    store.publish(np.zeros(8, dtype=np.float32))
    log = ChunkLog()
    gw = DcnGateway(store, clock, stats, put_chunk=log, host=LOCAL, port=0)
    holder = {"gw": gw}
    yield holder, store, clock, stats, log
    holder["gw"].close()


def _client(gw, slot=0, **kw):
    kw.setdefault("heartbeat_interval", 0)
    kw.setdefault("reconnect_timeout", 10.0)
    return DcnClient((LOCAL, gw.port), process_ind=slot, **kw)


def _restart(holder, store, clock, stats, log):
    port = holder["gw"].port
    holder["gw"].close()
    holder["gw"] = DcnGateway(store, clock, stats, put_chunk=log,
                              host=LOCAL, port=port)
    return holder["gw"]


class TestFaultInjector:
    def test_parse_and_fire(self):
        inj = FaultInjector(parse_faults("delay@1:0.01,sever@2,corrupt@3"))
        assert inj.frame(b"a") == b"a"
        assert inj.frame(b"b") == b"b"
        with pytest.raises(InjectedDisconnect):
            inj.frame(b"c")
        assert isinstance(InjectedDisconnect("x"), ConnectionError)
        assert inj.frame(b"dd") != b"dd"
        assert inj.injected == 3
        # the reference corrupts the same two bytes
        ref = jax_faults.FaultInjector(
            jax_faults.parse_faults("corrupt@0"))
        payload = bytes(range(40))
        assert (FaultInjector.scripted("corrupt@0").frame(payload)
                == ref.frame(payload))

    def test_crash_is_not_a_connection_error(self):
        with pytest.raises(InjectedCrash) as ei:
            FaultInjector.scripted("crash@0").frame()
        assert not isinstance(ei.value, ConnectionError)

    @pytest.mark.parametrize("spec", ["sever", "teleport@3", "sever@x"])
    def test_bad_specs_rejected(self, spec):
        for mod in (jax_faults, None):
            with pytest.raises(ValueError):
                (mod.parse_faults if mod else parse_faults)(spec)

    @pytest.mark.parametrize("seed,horizon", [(0, 4000), (7, 4000),
                                              (42, 10000), (3, 500)])
    def test_random_schedules_are_the_reference(self, seed, horizon,
                                                monkeypatch):
        ours = FaultInjector.random(seed, horizon=horizon)
        ref = jax_faults.FaultInjector.random(seed, horizon=horizon)
        assert ours._by_frame == ref._by_frame and ours._by_frame
        monkeypatch.setenv("DCN_FAULTS_CLIENT", f"random:{seed}:{horizon}")
        assert (FaultInjector.from_env("client")._by_frame
                == ref._by_frame)
        assert FaultInjector.random(seed + 1)._by_frame != \
            FaultInjector.random(seed)._by_frame

    def test_from_env(self, monkeypatch):
        monkeypatch.setenv("DCN_FAULTS_CLIENT", "sever@7")
        assert FaultInjector.from_env("client")._by_frame == \
            {7: [("sever", 0.0)]}
        monkeypatch.setenv("DCN_FAULTS_GATEWAY", "blackhole@2:0.5")
        assert FaultInjector.from_env("gateway")._by_frame == \
            {2: [("blackhole", 0.5)]}
        monkeypatch.delenv("DCN_FAULTS_CLIENT")
        assert FaultInjector.from_env("client")._by_frame == {}


class TestReconnect:
    def test_transparent_reconnect_after_gateway_restart(self, plane):
        holder, store, clock, stats, log = plane
        client = _client(holder["gw"])
        inc0 = client.incarnation
        gw2 = _restart(holder, store, clock, stats, log)
        client.tick(actor_steps=5)
        assert clock.actor_step.value == 5
        assert client.reconnects == 1
        assert client.incarnation > inc0
        assert gw2.active_slots == {0: client.incarnation}
        assert not client.disconnected.is_set()
        client.close()

    def test_unacked_chunk_resent_after_sever(self, plane):
        holder, *_rest, log = plane
        gw = holder["gw"]
        client = _client(gw, faults=FaultInjector.scripted("sever@1"))
        client.send_chunk([(tagged_transition(99), None)])
        assert log.tags == [99]
        assert client.reconnects == 1
        assert gw.active_slots == {0: client.incarnation}
        client.close()

    def test_corrupt_frame_rejected_then_resent(self, plane):
        holder, *_rest, log = plane
        client = _client(holder["gw"],
                         faults=FaultInjector.scripted("corrupt@1"))
        client.send_chunk([(tagged_transition(7), None)])
        assert log.tags == [7]
        assert client.reconnects == 1
        client.close()

    def test_gateway_side_corrupt_frame_drops_the_connection(self):
        clock, log = GlobalClock(), ChunkLog()
        gw = DcnGateway(ParamStore(8), clock, ActorStats(), put_chunk=log,
                        host=LOCAL, port=0,
                        faults=FaultInjector.scripted("corrupt@1"))
        try:
            client = _client(gw)
            client.send_chunk([(tagged_transition(3), None)])
            assert log.tags == [3] and client.reconnects == 1
            client.close()
        finally:
            gw.close()

    def test_blackhole_partition_then_heal(self, plane):
        holder, *_rest, log = plane
        client = _client(holder["gw"],
                         faults=FaultInjector.scripted("blackhole@1:0.4"))
        t0 = time.monotonic()
        client.send_chunk([(tagged_transition(1), None)])
        assert time.monotonic() - t0 >= 0.4
        assert log.tags == [1]
        assert client.reconnects == 1
        client.close()

    def test_terminal_disconnect_raises_nonzero_path(self, plane):
        holder, *_rest = plane
        client = _client(holder["gw"], reconnect_timeout=0.8)
        rclock = RemoteClock(client, flush_every=10 ** 9)
        holder["gw"].close()
        rclock._pending = 37
        t0 = time.monotonic()
        rclock.flush()
        assert time.monotonic() - t0 >= 0.7
        assert client.disconnected.is_set()
        assert not client.stop.is_set()
        assert rclock._pending == 37
        assert rclock.done(steps=10 ** 9)
        with pytest.raises(DcnDisconnected):
            client.tick(actor_steps=1)
        client.close()

    def test_poison_frame_goes_terminal_not_livelock(self, plane):
        holder, *_rest = plane
        spec = ",".join(f"corrupt@{i}" for i in range(1, 12))
        client = _client(holder["gw"], faults=FaultInjector.scripted(spec))
        with pytest.raises(DcnDisconnected, match="poison"):
            client.send_chunk([(tagged_transition(1), None)])
        assert client.disconnected.is_set()
        client.close()

    def test_injected_crash_propagates_uncaught(self, plane):
        holder, *_rest = plane
        client = _client(holder["gw"],
                         faults=FaultInjector.scripted("crash@1"))
        with pytest.raises(InjectedCrash):
            client.tick(actor_steps=1)
        client.close()


class TestWireHardening:
    def test_retransmitted_tick_not_double_counted(self, plane):
        holder, _store, clock, _stats, _log = plane
        s = socket.create_connection((LOCAL, holder["gw"].port))
        try:
            _send_frame(s, T_HELLO, json.dumps(
                {"role": "actor", "process_ind": 0,
                 "incarnation": 1}).encode())
            assert _recv_frame(s)[0] == T_CLOCK
            tick = json.dumps({"actor_steps": 40, "seq": 9,
                               "stats": {"nepisodes": 2.0}}).encode()
            _send_frame(s, T_TICK, tick)
            _recv_frame(s)
            _send_frame(s, T_TICK, tick)  # the resend: the same bytes
            _recv_frame(s)
            assert clock.actor_step.value == 40
            _send_frame(s, T_TICK, json.dumps(
                {"actor_steps": 2, "seq": 10}).encode())
            _recv_frame(s)
            assert clock.actor_step.value == 42
        finally:
            s.close()

    def test_malformed_hello_drops_connection_cleanly(self, plane):
        holder, *_ = plane
        gw = holder["gw"]
        s = socket.create_connection((LOCAL, gw.port))
        try:
            _send_frame(s, T_HELLO, json.dumps(
                {"role": "actor", "process_ind": "not-a-slot"}).encode())
            with pytest.raises(ConnectionError):
                while True:
                    _recv_frame(s)
        finally:
            s.close()
        assert gw.active_slots == {}
        survivor = _client(gw, slot=1)
        survivor.tick(actor_steps=1)
        survivor.close()


class TestHeartbeat:
    def test_idle_heartbeat_keeps_clock_fresh(self, plane):
        holder, _store, clock, *_rest = plane
        client = _client(holder["gw"], heartbeat_interval=0.15)
        clock.set_learner_step(77)
        deadline = time.monotonic() + 5
        while client.learner_step != 77:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        client.close()

    def test_heartbeat_reconnects_through_gateway_restart(self, plane):
        holder, store, clock, stats, log = plane
        client = _client(holder["gw"], heartbeat_interval=0.15)
        gw2 = _restart(holder, store, clock, stats, log)
        deadline = time.monotonic() + 10
        while not gw2.active_slots:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        while client.reconnects < 1:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert gw2.active_slots == {0: client.incarnation}
        client.close()

    def test_gateway_idle_deadline_reaps_frozen_peer(self):
        gw = DcnGateway(ParamStore(8), GlobalClock(), ActorStats(),
                        put_chunk=lambda items: None, host=LOCAL, port=0,
                        idle_deadline=0.4)
        try:
            frozen = _client(gw, slot=4)
            assert gw.active_slots == {4: frozen.incarnation}
            deadline = time.monotonic() + 5
            while gw.active_slots:
                assert time.monotonic() < deadline
                time.sleep(0.05)
            fresh = _client(gw, slot=4)
            assert gw.active_slots == {4: fresh.incarnation}
            fresh.close()
            frozen.close()
        finally:
            gw.close()


class TestChaosFleet:
    def test_gateway_restart_mid_run_zero_lost(self, plane):
        holder, store, clock, stats, log = plane
        gw = holder["gw"]
        fleet = [SyntheticActor((LOCAL, gw.port), slot=i, pace=0.001,
                                client_kwargs=dict(
                                    heartbeat_interval=0.25,
                                    reconnect_timeout=10.0)).start()
                 for i in range(3)]
        deadline = time.monotonic() + 10
        while len(log.tags) < 30:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        gw2 = _restart(holder, store, clock, stats, log)
        deadline = time.monotonic() + 20
        while set(gw2.active_slots) != {0, 1, 2}:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        marker = len(log.tags)
        while len(log.tags) < marker + 30:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        clock.set_learner_step(10)
        clock.stop.set()
        for a in fleet:
            a.thread.join(15)
            assert not a.thread.is_alive()
            assert a.outcome == "stopped"
            assert a.client.reconnects >= 1
            assert a.step_regressions == 0
        seen = log.seen()  # at least once: duplicates allowed, loss not
        for a in fleet:
            assert [t for t in a.acked_tags if t not in seen] == []
        deadline = time.monotonic() + 10
        while gw2.active_slots:
            assert time.monotonic() < deadline
            time.sleep(0.02)

    def test_duplicate_slot_race_single_winner(self, plane):
        holder, *_rest = plane
        gw = holder["gw"]
        a = _client(gw, slot=3, incarnation=100, reconnect_timeout=0.5)
        b = _client(gw, slot=3, incarnation=200)
        assert gw.fenced == 1
        assert gw.active_slots == {3: 200}
        b.tick(actor_steps=2)
        with pytest.raises(ConnectionError):
            a.tick(actor_steps=1)
        assert a.disconnected.is_set()
        a.close()
        time.sleep(0.2)
        assert gw.active_slots == {3: 200}
        b.tick(actor_steps=1)
        b.close()


class _FlakyTickClient:
    def __init__(self):
        self.stop = threading.Event()
        self.disconnected = threading.Event()
        self.learner_step = 0
        self.failures = 1
        self.ticked = []

    def tick(self, actor_steps=0, stats=None):
        if self.failures:
            self.failures -= 1
            raise ConnectionError("transient")
        self.ticked.append(actor_steps)
        return self.learner_step


def test_remote_clock_flush_restores_steps_on_failure():
    client = _FlakyTickClient()
    rclock = RemoteClock(client, flush_every=10 ** 9)
    rclock._pending = 300
    rclock.flush()
    assert rclock._pending == 300
    assert client.ticked == []
    rclock.flush()
    assert client.ticked == [300]
    assert rclock._pending == 0
