"""The port's learner replica plane (pytorch_distributed_tpu_torch/
parallel/dcn.py ``ReplicaRegistry``, ``LocalReplicaChannel``,
``ReplicaClient``; agents/learner.py ``ReplicaLearnerDriver``;
ops/losses.py ``build_dqn_grad_and_apply``; parallel/learner.py
``ReplicaExchange``) against tests/test_replicas.py and the JAX package:

- the reference's ``TestLeaseMembership``, ``TestRoundExchange``,
  ``TestRedialJitter`` and ``TestReplicaWire`` on the port;
- the degraded-parity oracle at row 1's size: two replicas through the
  real registry, replica 1 gone at round K; the survivor is the port's
  solo driver to the bit from K on (every param, the priorities, the
  draw seeds), and the dead generation's writes are counted rejects;
- a kill-then-rejoin drill through the epoch barrier over the port's
  gateway, with the reference's counter expectations and its
  ``replica_degraded`` alert fired and resolved;
- cross-wire: the JAX package's ``ReplicaClient`` against the port's
  registry and the port's against the JAX package's, with the same
  leases, generations, reduced means and stale-generation rejects;
- ``build_dqn_grad_and_apply`` against the JAX package's on the same
  weights and batch: fp32 within rtol 1e-4 / atol 1e-5 (the fused step's
  tolerance, tests/test_torch_losses.py); the bf16 torso within 2e-2 of
  each gradient leaf's largest entry (tests/test_torch_torso.py's bound:
  bf16 keeps 8 bits, summed in two orders), rtol and atol 2e-2 on |TD|
  and the metrics, and atol 2e-4 on the params (Adam moves a param by at
  most lr, 1e-4, a step);
- at world size 1 the halves with the exchange are the port's fused step
  to the bit (the kernel torso and B1 through their plain versions here);
- ``np_rng(seed, "replica-ingest", k)`` draws the reference's bytes.

Inputs come from numpy generators with fixed seeds; every gateway binds
127.0.0.1 on port 0.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu_torch.agents.clocks import ActorStats, GlobalClock
from pytorch_distributed_tpu_torch.agents.param_store import ParamStore
from pytorch_distributed_tpu_torch.config import ReplicaParams, build_options
from pytorch_distributed_tpu_torch.parallel.dcn import (
    RSTAT_FENCED, RSTAT_NOREG, RSTAT_OK, RSTAT_STALE, DcnClient, DcnGateway,
    LocalReplicaChannel, ReplicaClient, ReplicaFenced, ReplicaRegistry,
    fetch_status, redial_backoff, resolve_replica,
)

LOCAL = "127.0.0.1"


def _registry(replicas=2, lease_s=0.4, **kw) -> ReplicaRegistry:
    return ReplicaRegistry(ReplicaParams(replicas=replicas,
                                         lease_s=lease_s, **kw))


def _gateway(registry=None, health=None):
    store = ParamStore(4)
    store.publish(np.zeros(4, dtype=np.float32))
    return DcnGateway(store, GlobalClock(), ActorStats(),
                      put_chunk=lambda items: None, host=LOCAL, port=0,
                      replicas=registry, health=health)


# -- lease-fenced membership ----------------------------------------------------

class TestLeaseMembership:
    def test_acquire_grants_monotonic_generations(self):
        reg = _registry()
        g1 = reg.acquire(0, incarnation=10)["generation"]
        g2 = reg.acquire(1, incarnation=10)["generation"]
        assert g2 > g1
        assert sorted(reg.status_block()["members"]) == ["0", "1"]

    def test_missed_lease_expires_and_fences(self):
        reg = _registry(lease_s=0.15)
        reg.acquire(0, incarnation=1)
        time.sleep(0.3)
        reg.renew(0, -1)  # any registry call runs the expiry pass
        assert reg.leases_expired == 1
        assert reg.status_block()["members"] == {}
        assert reg.status_block()["degraded"]

    def test_renew_extends_and_expired_renew_says_so(self):
        reg = _registry(lease_s=0.3)
        g = reg.acquire(0, incarnation=1)["generation"]
        for _ in range(4):
            time.sleep(0.15)
            assert reg.renew(0, g)["status"] == "ok"
        time.sleep(0.6)
        assert reg.renew(0, g)["status"] == "expired"
        assert reg.leases_expired == 1

    def test_double_lease_newer_incarnation_wins(self):
        reg = _registry()
        g_old = reg.acquire(0, incarnation=5)["generation"]
        assert reg.acquire(0, incarnation=5)["status"] == "refused"
        assert reg.acquire(0, incarnation=4)["status"] == "refused"
        r = reg.acquire(0, incarnation=6)
        assert r["status"] == "ok" and r["generation"] > g_old
        assert reg.lease_fenced == 1
        res = reg.submit(0, g_old, 0, np.zeros(2, np.float32))
        assert res["status"] in (RSTAT_FENCED, RSTAT_STALE)
        assert reg.stale_grad_rejected == 1

    def test_release_shrinks_membership_immediately(self):
        reg = _registry()
        g = reg.acquire(0, incarnation=1)["generation"]
        reg.acquire(1, incarnation=1)
        reg.release(0, g)
        assert reg.leases_released == 1
        assert sorted(reg.status_block()["members"]) == ["1"]


class TestRoundExchange:
    def _pair(self, reg):
        a = LocalReplicaChannel(reg, 0)
        b = LocalReplicaChannel(reg, 1)
        a.acquire()
        b.acquire()
        return a, b

    def test_round_reduces_mean_in_replica_order(self):
        reg = _registry(lease_s=5.0)
        a, b = self._pair(reg)
        out = [None, None]

        def run(ch, i, v):
            out[i] = ch.submit_round(
                0, np.asarray([v, v], np.float32),
                pidx=np.asarray([i], np.int32),
                ptd=np.asarray([0.5 + i], np.float32))

        t = threading.Thread(target=run, args=(b, 1, 3.0), daemon=True)
        t.start()
        run(a, 0, 1.0)
        t.join(5)
        assert out[0]["status"] == RSTAT_OK
        assert np.array_equal(out[0]["grad"],
                              np.asarray([2.0, 2.0], np.float32))
        assert np.array_equal(out[0]["grad"], out[1]["grad"])
        assert out[0]["members"] == [0, 1]
        assert [w[0] for w in out[0]["writebacks"]] == [0, 1]
        assert [(w[0], list(w[1])) for w in out[0]["writebacks"]] == \
            [(w[0], list(w[1])) for w in out[1]["writebacks"]]

    def test_expiry_mid_round_completes_over_survivors(self):
        reg = _registry(lease_s=0.3)
        a, b = self._pair(reg)
        out = [None, None]

        def run0(ch, i):
            out[i] = ch.submit_round(0, np.ones(2, np.float32) * (i + 1))

        t = threading.Thread(target=run0, args=(b, 1), daemon=True)
        t.start()
        run0(a, 0)
        t.join(5)
        assert out[0]["status"] == RSTAT_OK
        g = np.asarray([7.5, -2.25], np.float32)
        t0 = time.monotonic()
        res = a.submit_round(1, g)
        took = time.monotonic() - t0
        assert res["status"] == RSTAT_OK and res["members"] == [0]
        assert np.array_equal(res["grad"], g)  # the mean over {A}
        assert took < 3 * 0.3 + 1.0
        assert reg.leases_expired == 1
        assert reg.degraded_completions == 1

    def test_hung_but_renewing_member_is_round_stalled(self):
        reg = _registry(lease_s=0.3)
        a, b = self._pair(reg)
        b.start_renewer(period=0.05)  # renews forever, submits never
        res = a.submit_round(0, np.ones(2, np.float32))
        assert res["status"] == RSTAT_OK and res["members"] == [0]
        assert reg.leases_expired == 1
        b.close()
        out = reg.submit(1, b.generation, 1, np.zeros(2, np.float32))
        assert out["status"] in (RSTAT_FENCED, RSTAT_STALE)
        assert reg.stale_grad_rejected == 1

    def test_stale_generation_prio_writeback_rejected(self):
        reg = _registry(lease_s=0.15)
        a, b = self._pair(reg)
        a.start_renewer(period=0.04)
        dead_gen = b.generation
        time.sleep(0.35)
        a.renew()
        assert reg.leases_expired >= 1
        res = reg.merge_prio(1, dead_gen, np.asarray([3], np.int32),
                             np.asarray([9.9], np.float32))
        assert res["status"] == "stale" and reg.stale_prio_rejected == 1
        ok = reg.merge_prio(0, a.generation, np.asarray([1], np.int32),
                            np.asarray([0.5], np.float32))
        assert ok["status"] == "ok" and reg.prio_merged_rows == 1
        out = a.submit_round(0, np.zeros(2, np.float32))
        assert (0, [1]) in [(w[0], list(w[1])) for w in out["writebacks"]]
        a.close()

    def test_rejoin_after_sigkill_new_generation_via_barrier(self):
        reg = _registry(lease_s=0.25, join_timeout_s=10.0)
        a, b = self._pair(reg)
        out = [None, None]

        def run0(ch, i):
            out[i] = ch.submit_round(0, np.ones(2, np.float32))

        t = threading.Thread(target=run0, args=(b, 1), daemon=True)
        t.start()
        run0(a, 0)
        t.join(5)
        dead_gen = b.generation  # killed here: no release
        assert a.submit_round(1, np.ones(2, np.float32))["members"] == [0]
        b2 = LocalReplicaChannel(reg, 1)
        reply = b2.acquire()
        assert reply["generation"] > dead_gen
        barrier = reply["epoch_barrier"]
        assert barrier is not None and reply["round"] == barrier + 1
        b2.start_renewer(period=0.05)
        committed = {}

        def survivor():
            r = 2
            while r <= barrier + 1:
                res = a.submit_round(r, np.full(2, float(r), np.float32))
                assert res["status"] == RSTAT_OK
                if res["epoch_due"]:
                    committed["step"] = r + 1
                    a.note_epoch(r, r + 1)
                r += 1
            committed["final_members"] = res["members"]

        ts = threading.Thread(target=survivor, daemon=True)
        ts.start()
        deadline = time.monotonic() + 8.0
        while time.monotonic() < deadline:
            j = b2.poll_join()
            if j and j.get("epoch_step") is not None:
                break
            time.sleep(0.02)
        assert j and j["epoch_step"] == committed["step"]
        b2.activate(j["epoch_step"])
        res = b2.submit_round(barrier + 1, np.full(2, float(barrier + 1),
                                                   np.float32))
        ts.join(10)
        assert res["status"] == RSTAT_OK and res["members"] == [0, 1]
        assert committed["final_members"] == [0, 1]
        assert reg.joins_completed == 1 and reg.leases_expired == 1
        z = reg.submit(1, dead_gen, barrier + 1, np.zeros(2, np.float32))
        assert z["status"] in (RSTAT_FENCED, RSTAT_STALE)
        b2.close()


# -- the redial jitter -----------------------------------------------------------

class TestRedialJitter:
    def _seq(self, slot, n=8):
        rng = np.random.default_rng((0xDC2, slot))
        d, seq = 0.05, []
        for _ in range(n):
            d = redial_backoff(rng, d)
            seq.append(d)
        return seq

    def test_slots_spread_their_redial_times(self):
        assert self._seq(0) != self._seq(1)
        assert self._seq(3) != self._seq(4)

    def test_deterministic_per_slot_and_bounded(self):
        assert self._seq(2) == self._seq(2)
        for d in self._seq(5, n=32):
            assert 0.05 <= d <= 1.0

    def test_dcn_client_carries_a_slot_seeded_stream(self):
        gw = _gateway()
        try:
            c0 = DcnClient((LOCAL, gw.port), process_ind=0)
            c1 = DcnClient((LOCAL, gw.port), process_ind=1)
            try:
                d0 = [redial_backoff(c0._redial_rng, 0.05) for _ in range(4)]
                d1 = [redial_backoff(c1._redial_rng, 0.05) for _ in range(4)]
                assert d0 != d1
            finally:
                c0.close()
                c1.close()
        finally:
            gw.close()


# -- over the wire -----------------------------------------------------------------

class TestReplicaWire:
    def test_lease_and_round_over_the_wire(self):
        reg = _registry(lease_s=1.0)
        gw = _gateway(reg)
        try:
            a = ReplicaClient((LOCAL, gw.port), 0)
            b = ReplicaClient((LOCAL, gw.port), 1)
            a.acquire()
            b.acquire()
            assert a.generation != b.generation
            out = [None, None]

            def run(ch, i, v):
                out[i] = ch.submit_round(
                    0, np.asarray([v], np.float32),
                    pidx=np.asarray([i], np.int32),
                    ptd=np.asarray([1.0], np.float32))

            t = threading.Thread(target=run, args=(b, 1, 4.0), daemon=True)
            t.start()
            run(a, 0, 2.0)
            t.join(5)
            for o in out:
                assert o["status"] == RSTAT_OK
                assert np.array_equal(o["grad"],
                                      np.asarray([3.0], np.float32))
                assert o["members"] == [0, 1] and len(o["writebacks"]) == 2
            for c in (a, b):
                c.release()
                c.close()
        finally:
            gw.close()

    def test_stale_generation_fenced_over_the_wire(self):
        reg = _registry(lease_s=0.2)
        gw = _gateway(reg)
        try:
            a = ReplicaClient((LOCAL, gw.port), 0)
            a.acquire()
            dead = a.generation
            time.sleep(0.5)  # expires: no renewer
            res = a.submit_round(0, np.zeros(2, np.float32))
            assert res["status"] in (RSTAT_FENCED, RSTAT_STALE)
            assert a.fenced.is_set()
            z = ReplicaClient((LOCAL, gw.port), 0)
            z.generation = dead
            assert z.merge_prio(np.asarray([0], np.int32),
                                np.asarray([1.0], np.float32)
                                )["status"] == "stale"
            z.close()
            a.close()
            assert reg.stale_grad_rejected == 1
            assert reg.stale_prio_rejected == 1
        finally:
            gw.close()

    def test_registryless_gateway_answers_errors_not_crashes(self):
        gw = _gateway(None)
        try:
            c = ReplicaClient((LOCAL, gw.port), 0)
            with pytest.raises(ReplicaFenced):
                c.acquire()
            c.generation = 1
            assert c.submit_round(0, np.zeros(2, np.float32)
                                  )["status"] == RSTAT_NOREG
            c.close()
        finally:
            gw.close()

    def test_fleet_top_replicas_panel_and_json(self):
        """The STATUS ``replicas`` block crosses the wire, stays JSON and
        renders in the reference's fleet monitor as its own does."""
        import tools.fleet_top as ft

        reg = _registry(replicas=2, lease_s=5.0)
        gw = _gateway(reg)
        try:
            a = LocalReplicaChannel(reg, 0)
            a.acquire()
            status = fetch_status((LOCAL, gw.port))
            assert "replicas" in status
            json.dumps(status)
            line = ft.replicas_line(status)
            assert "1/2" in line and "DEGRADED" in line and "r0" in line
            LocalReplicaChannel(reg, 1).acquire()
            line = ft.replicas_line(fetch_status((LOCAL, gw.port)))
            assert "2/2" in line and "DEGRADED" not in line
        finally:
            gw.close()

    def test_resolve_replica_env_contract(self, monkeypatch):
        monkeypatch.setenv("TPU_APEX_REPLICA_REPLICAS", "3")
        monkeypatch.setenv("TPU_APEX_REPLICA_LEASE_S", "2.5")
        rp = resolve_replica()
        assert rp.replicas == 3 and rp.lease_s == 2.5
        base = ReplicaParams(lease_s=9.0)
        assert resolve_replica(base).lease_s == 2.5  # the env wins
        assert base.lease_s == 9.0  # the input is never mutated


# -- options --------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["lease_s", "renew_s", "join_timeout_s",
                                 "coordinator", "enabled"])
def test_a_bare_shared_field_is_refused_as_the_reference_refuses_it(key):
    from pytorch_distributed_tpu.config import build_options as jax_options

    with pytest.raises(ValueError, match="ambiguous"):
        jax_options(1, **{key: 1})
    with pytest.raises(ValueError, match="ambiguous"):
        build_options(1, **{key: 1})


@pytest.mark.parametrize("key,group", [
    ("replicas", "replica_params"), ("round_timeout_s", "replica_params"),
    ("sync_s", "gateway_params"), ("standby", "gateway_params"),
    ("endpoints", "gateway_params")])
def test_a_bare_field_of_one_group_is_routed_as_the_reference_routes_it(
        key, group):
    from pytorch_distributed_tpu.config import build_options as jax_options

    val = "h:1" if key in ("standby", "endpoints") else 3
    assert getattr(getattr(build_options(1, **{key: val}), group), key) \
        == getattr(getattr(jax_options(1, **{key: val}), group), key) == val
    opt = build_options(1, **{"replica_params.lease_s": 0.6,
                              "gateway_params.lease_s": 1.5})
    assert (opt.replica_params.lease_s, opt.gateway_params.lease_s) == (
        0.6, 1.5)


# -- the seeds -------------------------------------------------------------------------

@pytest.mark.parametrize("k", [0, 1, 17])
def test_np_rng_replica_ingest_draws_the_references_bytes(k):
    from pytorch_distributed_tpu.utils import rngs as jax_rngs
    from pytorch_distributed_tpu_torch.utils import rngs

    for role in ("replica-ingest", "replica-plane"):
        a = rngs.np_rng(11, role, k)
        b = jax_rngs.np_rng(11, role, k)
        assert a.bytes(64) == b.bytes(64)
        assert rngs.process_seed(11, role, k) == jax_rngs.process_seed(
            11, role, k)


def test_the_shared_ingest_stream_is_the_references():
    """The driver's synthetic chunk at a counter: the reference's rows."""
    from pytorch_distributed_tpu_torch.agents.learner import (
        ReplicaLearnerDriver,
    )
    from pytorch_distributed_tpu_torch.factory import probe_env

    opt = _oracle_opt("/tmp/unused")
    drv = ReplicaLearnerDriver.__new__(ReplicaLearnerDriver)
    drv.opt, drv.spec, drv._ingest_counter = opt, probe_env(opt), 3
    chunk = drv._synth_chunk(16)
    rng = __import__("pytorch_distributed_tpu.utils.rngs",
                     fromlist=["np_rng"]).np_rng(opt.seed, "replica-ingest", 3)
    shape = (16,) + tuple(drv.spec.state_shape)
    want_s0 = rng.standard_normal(shape).astype(np.float32)
    want_s1 = rng.standard_normal(shape).astype(np.float32)
    want_a = rng.integers(0, drv.spec.num_actions, size=(16,)).astype(
        np.int32)
    assert np.array_equal(chunk.state0, want_s0)
    assert np.array_equal(chunk.state1, want_s1)
    assert np.array_equal(chunk.action, want_a)
    assert drv._ingest_counter == 4


# -- the degraded-parity oracle ---------------------------------------------------------

def _oracle_opt(root, refs="replicas-oracle"):
    opt = build_options(
        1, root_dir=str(root), refs=refs, seed=11, hidden_dim=32,
        batch_size=8, memory_size=128, learn_start=32, steps=10_000,
        replicas=2, evaluator_nepisodes=0, device="cpu")
    # lease_s lives on the replica and the gateway planes: set it directly
    opt.replica_params.lease_s = 0.6
    return opt


@pytest.mark.timeout(120)
def test_survivor_bit_identical_to_solo_from_degradation(tmp_path):
    """Two replicas through the registry; replica 1 stops submitting and
    renewing at round K (SIGKILL's image in process).  From K on the
    survivor is a solo driver started from its state at the boundary, to
    the bit: every param, the target, Adam's moments, the priorities and
    the draws' seeds; the dead generation's priority and gradient writes
    are counted rejects."""
    from pytorch_distributed_tpu_torch.agents.learner import (
        ReplicaLearnerDriver,
    )
    from pytorch_distributed_tpu_torch.factory import probe_env

    opt = _oracle_opt(tmp_path)
    spec = probe_env(opt)
    reg = ReplicaRegistry(resolve_replica(opt.replica_params))
    chA, chB = LocalReplicaChannel(reg, 0), LocalReplicaChannel(reg, 1)
    dA = ReplicaLearnerDriver(opt, spec, 0, chA)
    dB = ReplicaLearnerDriver(opt, spec, 1, chB)
    for ch in (chA, chB):
        ch.acquire()
        ch.start_renewer(period=0.1)
    for d in (dA, dB):
        d.members = [0, 1]
        d.prefill(64)
    K, T = 4, 9
    traj, traj_b = {}, {}

    def run_b():
        dB.run_rounds(K, capture=lambda r, d: traj_b.__setitem__(
            r, d.snapshot()))
        chB.close()  # the renewer dies with the process

    tb = threading.Thread(target=run_b, daemon=True)
    tb.start()
    dA.run_rounds(T, capture=lambda r, d: traj.__setitem__(r, d.snapshot()))
    tb.join(30)
    assert not tb.is_alive()
    chA.close()
    assert reg.leases_expired == 1 and reg.degraded_completions >= 1
    assert dA.members == [0]
    for r in range(K):  # one model while both trained
        for k, v in traj[r]["state"].params.items():
            assert torch.equal(v, traj_b[r]["state"].params[k])
    dead_gen = chB.generation
    assert reg.merge_prio(1, dead_gen, np.asarray([0], np.int32),
                          np.asarray([99.0], np.float32))["status"] == "stale"
    assert reg.stale_prio_rejected == 1
    assert reg.submit(1, dead_gen, T - 1, np.zeros(2, np.float32)
                      )["status"] in (RSTAT_FENCED, RSTAT_STALE)

    reg2 = ReplicaRegistry(ReplicaParams(replicas=1, lease_s=5.0))
    chS = LocalReplicaChannel(reg2, 0)
    dS = ReplicaLearnerDriver(opt, spec, 0, chS)
    chS.acquire()
    chS.start_renewer(period=0.5)
    dS.load_snapshot(traj[K - 1])
    dS.members = [0]
    solo = {}
    dS.run_rounds(T, capture=lambda r, d: solo.__setitem__(r, d.snapshot()))
    chS.close()
    for r in range(K, T):
        a, s = traj[r]["state"], solo[r]["state"]
        for tree_a, tree_s in ((a.params, s.params),
                               (a.target_params, s.target_params),
                               (a.opt_state.mu, s.opt_state.mu),
                               (a.opt_state.nu, s.opt_state.nu)):
            for k, v in tree_a.items():
                assert torch.equal(v, tree_s[k]), f"{k} at round {r}"
        assert int(a.step) == int(s.step)
        ra, rs = traj[r]["ring"], solo[r]["ring"]
        assert torch.equal(ra.priority, rs.priority), r
        assert torch.equal(ra.max_priority, rs.max_priority), r
    ka, ks = dict(dA.key_log), dict(dS.key_log)
    for r in range(K, T):
        assert np.array_equal(ka[r], ks[r]), f"draw seed at round {r}"


# -- the kill-then-rejoin drill -------------------------------------------------------

class _Writer:
    """A ``MetricsWriter``'s ``scalar``/``flush`` into mission control's
    series, for a registry with no log dir."""

    def __init__(self, metrics):
        self._metrics = metrics

    def scalar(self, tag, value, step=0, wall=None):
        self._metrics.ingest([{"tag": tag, "value": float(value),
                               "wall": wall or time.time(),
                               "step": int(step), "role": "gateway"}])

    def flush(self):
        pass


class _Replica:
    """A numpy replica over a ``ReplicaClient``: a toy params vector in
    place of the train state, the real lease, round and fencing
    machinery.  ``kill_at``: stop at that round with no release (the
    renewer dies with it).  ``join``: enter through the epoch barrier,
    loading the survivors' epoch from ``store``."""

    def __init__(self, addr, rid, rounds, store, kill_at=None, join=False,
                 hold=None):
        self.addr, self.rid, self.rounds = addr, rid, rounds
        self.store, self.kill_at, self.join = store, kill_at, join
        self.hold = hold
        self.rng = np.random.default_rng((5, rid))
        self.params = np.zeros(16, np.float32)
        self.history = {}
        self.dead_generation = None
        self.outcome = None
        self.done = threading.Event()
        self.thread = threading.Thread(target=self.run, daemon=True)
        self.thread.start()

    def run(self):
        c = self.client = ReplicaClient(self.addr, self.rid)
        reply = c.acquire()
        c.start_renewer()
        r = int(reply.get("round", 0))
        if reply.get("epoch_barrier") is None:
            c.wait_members(2, timeout=10.0)
        else:
            deadline = time.monotonic() + 20.0
            step = None
            while time.monotonic() < deadline and step is None:
                j = c.poll_join()
                step = None if j is None else j.get("epoch_step")
                time.sleep(0.02)
            while self.store.get("step", -1) < step:
                time.sleep(0.02)
            self.params = self.store["params"].copy()
            c.activate(step)
        while r < self.rounds:
            if r == self.kill_at:
                self.outcome = "killed"
                self.dead_generation = c.generation
                c.close()
                return
            res = c.submit_round(
                r, self.rng.standard_normal(16).astype(np.float32),
                pidx=np.asarray([r % 16], np.int32),
                ptd=np.asarray([0.5], np.float32))
            assert res["status"] == RSTAT_OK, res
            if res["grad"] is not None:
                self.params = self.params - 0.1 * res["grad"]
            self.history[r] = self.params.copy()
            if res["epoch_due"] and res["members"][0] == self.rid:
                self.store.update(step=r + 1, params=self.params.copy())
                c.note_epoch(r, r + 1)
            r += 1
            time.sleep(0.04)
        self.done.set()
        self.hold.wait(30.0)
        self.outcome = "done"
        c.release()
        c.close()


@pytest.mark.timeout(90)
def test_kill_then_rejoin_drill_through_the_epoch_barrier():
    """The reference's drill (tests/test_replicas.py :455-471) on the port:
    replica 1 dies at round 8 with no release; the survivor degrades; a
    replacement leases at a new generation, loads the barrier epoch and
    activates; the zombie's stale gradient and priority write are each a
    counted reject; the ``replica_degraded`` alert fires and resolves and
    nothing else fires; and the replicas agree on every common round."""
    from pytorch_distributed_tpu_torch.config import (
        AlertParams, MetricsParams,
    )
    from pytorch_distributed_tpu_torch.utils import telemetry

    mission = telemetry.MissionControl(
        None, MetricsParams(enabled=True, poll_s=0.1), AlertParams(
            rules="replica_degraded: replica/members < 2 for 0.3s; "
                  "replica_churny: replica/generation_churn > 50 for 2s"))
    mission.start()
    reg = ReplicaRegistry(ReplicaParams(replicas=2, lease_s=0.6,
                                        join_timeout_s=15.0),
                          writer=_Writer(mission.metrics))
    gw = _gateway(reg, health=mission.status_block)
    addr, store, hold = (LOCAL, gw.port), {}, threading.Event()
    try:
        a = _Replica(addr, 0, 45, store, hold=hold)
        b = _Replica(addr, 1, 45, store, kill_at=8, hold=hold)
        b.thread.join(30)
        assert b.outcome == "killed"
        deadline = time.monotonic() + 10
        while not reg.status_block()["degraded"] \
                or "replica_degraded" not in mission.engine.firing():
            assert time.monotonic() < deadline
            time.sleep(0.05)
        j = _Replica(addr, 1, 45, store, join=True, hold=hold)
        assert a.done.wait(30) and j.done.wait(30)
        zc = ReplicaClient(addr, 1)
        zc.generation = b.dead_generation
        assert zc.submit_round(44, np.zeros(16, np.float32))["status"] in (
            RSTAT_FENCED, RSTAT_STALE)
        assert zc.merge_prio(np.asarray([0], np.int32),
                             np.asarray([9.9], np.float32)
                             )["status"] == "stale"
        zc.close()
        deadline = time.monotonic() + 5
        while mission.engine.firing():
            assert time.monotonic() < deadline, mission.engine.firing()
            time.sleep(0.05)
        counters = fetch_status(addr)["replicas"]["counters"]
        hold.set()
        a.thread.join(10)
        j.thread.join(10)
        assert counters["leases_expired"] == 1
        assert counters["joins_completed"] == 1
        assert counters["stale_grad_rejected"] == 1
        assert counters["stale_prio_rejected"] == 1
        assert counters["lease_fenced"] == 0
        assert counters["leases_granted"] == 3
        assert reg.leases_released == 2
        for r in range(45):
            if r in a.history and r in j.history:
                assert np.array_equal(a.history[r], j.history[r]), r
            if r < 8:
                assert np.array_equal(a.history[r], b.history[r]), r
        assert set(j.history) >= set(range(max(j.history) - 5,
                                           max(j.history) + 1))
        assert "replica_churny" not in mission.engine.firing()
    finally:
        hold.set()
        gw.close()
        mission.stop()


# -- cross-wire --------------------------------------------------------------------

def _jax_gateway(registry):
    from pytorch_distributed_tpu.agents import clocks as jc
    from pytorch_distributed_tpu.agents import param_store as jps
    from pytorch_distributed_tpu.parallel import dcn as jax_dcn

    store = jps.ParamStore(4)
    store.publish(np.zeros(4, dtype=np.float32))
    return jax_dcn.DcnGateway(store, jc.GlobalClock(), jc.ActorStats(),
                              put_chunk=lambda items: None, host=LOCAL,
                              port=0, replicas=registry)


@pytest.mark.timeout(60)
@pytest.mark.parametrize("server", ["port", "jax"])
def test_cross_wire_leases_rounds_and_stale_rejects(server):
    """A JAX ``ReplicaClient`` and a port ``ReplicaClient`` as the two
    members of one registry, the port's behind the port's gateway and the
    JAX package's behind its own: the same generations, the same mean of
    [2, 4] and [6, 8], the same write-back groups, and a stale
    generation's round and priority write each a counted reject."""
    from pytorch_distributed_tpu.config import ReplicaParams as JaxRP
    from pytorch_distributed_tpu.parallel import dcn as jax_dcn

    if server == "port":
        reg = _registry(lease_s=0.5)
        gw = _gateway(reg)
    else:
        reg = jax_dcn.ReplicaRegistry(JaxRP(replicas=2, lease_s=0.5))
        gw = _jax_gateway(reg)
    try:
        addr = (LOCAL, gw.port)
        a = jax_dcn.ReplicaClient(addr, 0)
        b = ReplicaClient(addr, 1)
        ga, gb = a.acquire()["generation"], b.acquire()["generation"]
        assert (ga, gb) == (1, 2)
        out = [None, None]

        def run(ch, i, v):
            out[i] = ch.submit_round(
                0, np.asarray(v, np.float32),
                pidx=np.asarray([i, 5], np.int32),
                ptd=np.asarray([0.25, 1.5 + i], np.float32))

        t = threading.Thread(target=run, args=(b, 1, [6.0, 8.0]),
                             daemon=True)
        t.start()
        run(a, 0, [2.0, 4.0])
        t.join(10)
        for o in out:
            assert o["status"] == RSTAT_OK and o["members"] == [0, 1]
            assert np.array_equal(o["grad"], np.asarray([4.0, 6.0],
                                                        np.float32))
            assert [(w[0], w[1].tolist(), w[2].tolist())
                    for w in o["writebacks"]] == [
                (0, [0, 5], [0.25, 1.5]), (1, [1, 5], [0.25, 2.5])]
        b.close()  # no renewers: both leases run out, b's is stale
        time.sleep(0.8)
        z = ReplicaClient(addr, 1)
        z.generation = gb
        assert z.submit_round(1, np.zeros(2, np.float32))["status"] in (
            RSTAT_FENCED, RSTAT_STALE)
        assert z.merge_prio(np.asarray([0], np.int32),
                            np.asarray([1.0], np.float32))["status"] \
            == "stale"
        z.close()
        assert (reg.stale_grad_rejected, reg.stale_prio_rejected,
                reg.leases_expired) == (1, 1, 2)
        assert reg.acquire(1, incarnation=time.time_ns())["generation"] == 3
        a.close()
    finally:
        gw.close()


def test_the_round_codec_is_the_references():
    """Each package decodes the other's round, reply and priority frames
    to the same columns (savez bytes carry zip timestamps)."""
    from pytorch_distributed_tpu.parallel import dcn as jax_dcn
    from pytorch_distributed_tpu_torch.parallel import dcn

    rng = np.random.default_rng(0)
    grad = rng.standard_normal(37).astype(np.float32)
    pidx = rng.integers(0, 100, 5).astype(np.int32)
    ptd = rng.random(5).astype(np.float32)
    wb = [(0, pidx[:2], ptd[:2]), (3, pidx[2:], ptd[2:])]
    for enc, dec in ((dcn, jax_dcn), (jax_dcn, dcn)):
        cols = dec._unpack_round(enc._pack_round(2, 7, 11, True, grad,
                                                 pidx, ptd))
        assert cols["meta"].tolist() == [2, 7, 11]
        assert np.array_equal(cols["grad"], grad)
        assert np.array_equal(cols["pidx"], pidx)
        rep = dec._unpack_round_reply(enc._pack_round_reply(
            0, 7, 11, grad, (0, 3), 2, True, wb))
        assert (rep["status"], rep["generation"], rep["round"],
                rep["members"], rep["applied"], rep["epoch_due"]) == (
            0, 7, 11, [0, 3], 2, True)
        assert np.array_equal(rep["grad"], grad)
        assert [(s, i.tolist(), t.tolist()) for s, i, t in
                rep["writebacks"]] == [(s, i.tolist(), t.tolist())
                                       for s, i, t in wb]
    assert dcn.REPLICA_WIRE_COLUMNS == jax_dcn.REPLICA_WIRE_COLUMNS
    assert (dcn.RSTAT_OK, dcn.RSTAT_FENCED, dcn.RSTAT_STALE,
            dcn.RSTAT_TIMEOUT, dcn.RSTAT_NOREG) == (
        jax_dcn.RSTAT_OK, jax_dcn.RSTAT_FENCED, jax_dcn.RSTAT_STALE,
        jax_dcn.RSTAT_TIMEOUT, jax_dcn.RSTAT_NOREG)


# -- the grad/apply halves ---------------------------------------------------------

FRAME = (4, 44, 44)  # conv stack 10x10 -> 4x4 -> 2x2
ACTIONS, B = 6, 4


def _batch(seed: int):
    from pytorch_distributed_tpu.utils.experience import Batch as JaxBatch
    from pytorch_distributed_tpu_torch.utils.experience import Batch

    rng = np.random.default_rng(seed)
    cols = dict(
        state0=rng.integers(0, 255, (B, *FRAME)).astype(np.uint8),
        action=rng.integers(0, ACTIONS, B).astype(np.int32),
        reward=rng.normal(size=B).astype(np.float32),
        gamma_n=np.full(B, 0.99 ** 5, np.float32),
        state1=rng.integers(0, 255, (B, *FRAME)).astype(np.uint8),
        terminal1=(rng.random(B) < 0.3).astype(np.float32),
        weight=rng.uniform(0.2, 1.0, B).astype(np.float32),
        index=np.arange(B, dtype=np.int32))
    return (JaxBatch(**cols),
            Batch(**{k: torch.from_numpy(v.copy()) for k, v in cols.items()}))


@pytest.mark.parametrize("dtype,rtol,atol", [("float32", 1e-4, 1e-5),
                                             ("bfloat16", 2e-2, 2e-2)])
def test_grad_and_apply_match_the_references(dtype, rtol, atol):
    """``grad_fn`` and ``apply_grads`` of both packages on the same
    weights (``convert.convert_dqn_cnn``) and batch, double DQN on: the
    gradients, |TD|, the metrics, ``ok`` and the applied state, the port's
    kernel torso (its plain version here) against the module forward of
    the reference."""
    import jax

    from pytorch_distributed_tpu.config import build_options as jax_options
    from pytorch_distributed_tpu.factory import (
        EnvSpec as JaxEnvSpec, build_model as jax_build_model,
        build_replica_grad_apply as jax_grad_apply,
        build_train_state_and_step as jax_state_and_step,
        init_params as jax_init_params,
    )
    from pytorch_distributed_tpu_torch.convert import convert_dqn_cnn
    from pytorch_distributed_tpu_torch.factory import (
        EnvSpec, build_model, build_replica_grad_apply,
        build_train_state_and_step,
    )

    kw = dict(compute_dtype=dtype, target_model_update=2,
              enable_double=True)
    jopt = jax_options(12, **kw)
    jspec = JaxEnvSpec(state_shape=FRAME, discrete=True,
                       num_actions=ACTIONS, action_dim=0, norm_val=255.0)
    jmodel = jax_build_model(jopt, jspec)
    jparams = jax_init_params(jopt, jspec, jmodel, seed=0)
    jstate, _ = jax_state_and_step(jopt, jspec, jmodel, jparams)
    jgrad, japply = jax_grad_apply(jopt, jmodel)
    opt = build_options(12, device="cpu", pallas_torso=True, **kw)
    model = build_model(opt, EnvSpec(FRAME, ACTIONS, 255.0))
    state, _ = build_train_state_and_step(
        opt, model, convert_dqn_cnn(jax.device_get(jparams), FRAME))
    grad_fn, apply_fn = build_replica_grad_apply(opt, model)
    jb, tb = _batch(3)
    jg, jok, jm, jtd = jax.jit(jgrad)(jstate, jb)
    g, ok, m, td = grad_fn(state, tb)
    assert float(ok) == float(jok) == 1.0
    ref = convert_dqn_cnn(jax.device_get(jg), FRAME)
    bf16 = dtype == "bfloat16"
    for k, v in ref.items():
        # bf16: within 2e-2 of the leaf's largest entry (as
        # tests/test_torch_torso.py holds the torso's gradients)
        np.testing.assert_allclose(
            g[k].numpy(), v.numpy(), rtol=0.0 if bf16 else rtol,
            atol=2e-2 * float(v.abs().max()) if bf16 else atol,
            err_msg=f"grad {k}")
    np.testing.assert_allclose(td.numpy(), np.asarray(jtd), rtol=rtol,
                               atol=atol)
    for key in ("learner/critic_loss", "learner/q_mean",
                "learner/grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                   rtol=rtol, atol=atol, err_msg=key)
    jnew = jax.jit(japply)(jstate, jg, jok)
    new = apply_fn(state, g, ok)
    got = convert_dqn_cnn(jax.device_get(jnew.params), FRAME)
    for k, v in got.items():
        # Adam moves each param by at most lr (1e-4) a step, so bf16's
        # gradients can part the params by 2 lr at most
        np.testing.assert_allclose(new.params[k].numpy(), v.numpy(),
                                   rtol=rtol if not bf16 else 0.0,
                                   atol=atol if not bf16 else 2e-4,
                                   err_msg=k)
    assert int(new.step) == int(jnew.step) == 1
    skipped = apply_fn(state, g, 0.0)
    for k, v in state.params.items():
        assert torch.equal(skipped.params[k], v)
    assert int(skipped.step) == 0


@pytest.mark.parametrize("enable_double", [False, True])
def test_the_halves_at_world_size_1_are_the_fused_step(enable_double):
    """One update of the port's fused PER step (K 1, the kernel torso)
    against the replica's halves on the same ring, state and uniforms,
    with the gradient through ``ReplicaExchange`` and a registry of one
    member and the write-back from the reply: the state and the ring's
    priorities to the bit, three updates in a row."""
    from pytorch_distributed_tpu_torch.factory import (
        EnvSpec, build_model, build_replica_grad_apply,
        build_train_state_and_step, init_params,
    )
    from pytorch_distributed_tpu_torch.memory.device_per import (
        DevicePerReplay, per_apply_writeback_groups, per_sample,
    )
    from pytorch_distributed_tpu_torch.parallel.learner import (
        ReplicaExchange,
    )
    from pytorch_distributed_tpu_torch.utils.experience import Transition

    opt = build_options(12, device="cpu", pallas_torso=True,
                        enable_double=enable_double, target_model_update=2)
    spec = EnvSpec(FRAME, ACTIONS, 255.0)
    model = build_model(opt, spec)
    params = init_params(opt, spec, seed=1, device="cpu")
    state_f, step = build_train_state_and_step(opt, model, params)
    state_h = state_f
    grad_fn, apply_fn = build_replica_grad_apply(opt, model)
    rings = [DevicePerReplay(64, FRAME) for _ in range(2)]
    rng = np.random.default_rng(4)
    rows = Transition(
        state0=rng.integers(0, 255, (48, *FRAME)).astype(np.uint8),
        action=rng.integers(0, ACTIONS, 48).astype(np.int32),
        reward=rng.normal(size=48).astype(np.float32),
        gamma_n=np.full(48, 0.99 ** 5, np.float32),
        state1=rng.integers(0, 255, (48, *FRAME)).astype(np.uint8),
        terminal1=(rng.random(48) < 0.2).astype(np.float32))
    for ring in rings:
        ring.feed_chunk(rows)
    fused = rings[0].build_fused_step(step, B)
    reg = _registry(replicas=1, lease_s=5.0)
    ch = LocalReplicaChannel(reg, 0)
    ch.acquire()
    exchange = ReplicaExchange(ch, FRAME)
    for r in range(3):
        us = torch.from_numpy(rng.random(B).astype(np.float32))
        state_f, _ = fused(state_f, rings[0].state, us[None], 0.6)
        batch = per_sample(rings[1].state, us, 0.6)
        grads, ok, _m, td = grad_fn(state_h, batch)
        reply, reduced = exchange.exchange(
            r, grads, ok=bool(ok > 0), pidx=batch.index.numpy(),
            ptd=td.numpy())
        assert reply["members"] == [0] and reply["applied"] == 1
        state_h = apply_fn(state_h, reduced, 1.0)
        per_apply_writeback_groups(rings[1].state,
                                   [(w[1], w[2]) for w in
                                    reply["writebacks"]],
                                   rings[1].alpha)
        for tf, th in ((state_f.params, state_h.params),
                       (state_f.target_params, state_h.target_params),
                       (state_f.opt_state.mu, state_h.opt_state.mu),
                       (state_f.opt_state.nu, state_h.opt_state.nu)):
            for k, v in tf.items():
                assert torch.equal(v, th[k]), (r, k)
        assert torch.equal(rings[0].state.priority, rings[1].state.priority)
        assert torch.equal(rings[0].state.max_priority,
                           rings[1].state.max_priority)
