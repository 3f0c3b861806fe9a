"""The port's local flow control (utils/flow.py) against the JAX
package's, on the CPU:

- ``DropOldestRing`` drops the same chunks, in the same order, and
  stamps the same counts (chunks, rows, rows per actor from the rows'
  provenance, the high-water mark) as the reference's, for chunks of the
  reference's ``(Transition, priority)`` pairs and of the port's bare
  Transitions;
- ``shed_overflow`` keeps the same rows and counts the same
  ``shed_rows`` and ``shed_by_actor:<id>``;
- ``resolve_flow`` reads the same ``TPU_APEX_FLOW*`` overrides;
- under the default ``block`` a feeder's output is its rows, unchanged
  and in order; under ``shed`` a full queue never stalls the feeder, and
  the device ingest's pending bound sheds the oldest rows, with
  ingested + shed == minted."""

import queue

import numpy as np
import pytest

from pytorch_distributed_tpu.utils import experience as jexp
from pytorch_distributed_tpu.utils import flow as jflow
from pytorch_distributed_tpu_torch.memory.device_replay import (
    DevicePerIngest,
)
from pytorch_distributed_tpu_torch.memory.feeder import QueueFeeder
from pytorch_distributed_tpu_torch.utils import flow, tracing
from pytorch_distributed_tpu_torch.utils.experience import (
    Transition, make_prov,
)

FRAME = (2, 3, 3)


def _kw(i):
    return dict(state0=np.full(FRAME, i % 251, np.uint8),
                action=np.int32(i % 6), reward=np.float32(i),
                gamma_n=np.float32(0.9), state1=np.zeros(FRAME, np.uint8),
                terminal1=np.float32(0))


def _prov(i):
    return None if i % 7 == 0 else make_prov(i % 3, i % 4, 1, i)


def _chunks(sizes):
    port, ref, i = [], [], 0
    for n in sizes:
        port.append([Transition(**_kw(j), prov=_prov(j))
                     for j in range(i, i + n)])
        ref.append([(jexp.Transition(**_kw(j), prov=_prov(j)), None)
                    for j in range(i, i + n)])
        i += n
    return port, ref


@pytest.mark.parametrize("owner", [-1, 5])
def test_drop_oldest_ring_is_the_reference(owner):
    sizes = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
    port, ref = _chunks(sizes)
    ring, jring = flow.DropOldestRing(3, owner), jflow.DropOldestRing(3,
                                                                      owner)
    for k, (pc, rc) in enumerate(zip(port, ref)):
        assert ring.put(pc) == jring.put(rc)
        if k == 6:  # a pop and an unpop mid-stream
            a, b = ring.pop(), jring.pop()
            assert len(a) == len(b)
            ring.unpop(a)
            jring.unpop(b)
    for attr in ("dropped_chunks", "dropped_rows", "buffered_high",
                 "dropped_by_actor", "buffered_rows"):
        assert getattr(ring, attr) == getattr(jring, attr), attr
    assert ring.dropped_by_actor.get(owner, 0) > 0
    left = []
    while (c := ring.pop()) is not None:
        left.append([float(t.reward) for t in c])
    jleft = []
    while (c := jring.pop()) is not None:
        jleft.append([float(t.reward) for t, _p in c])
    assert left == jleft and len(left) == 3


def test_shed_overflow_is_the_reference():
    port, ref = _chunks([40])
    got, want = {}, {}
    kept = flow.shed_overflow(port[0], 25, got)
    jkept = jflow.shed_overflow(ref[0], 25, want)
    # the reference stamps (t, p) pairs by their first item, as they come
    # from its queue; the port's pending rows are bare Transitions
    assert [float(t.reward) for t in kept] == [
        float(t.reward) for t, _p in jkept]
    assert got["shed_rows"] == 15
    bare = {}
    jflow.shed_overflow([t for t, _p in ref[0]], 25, bare)
    assert got == bare
    assert flow.shed_overflow(port[0][:10], 25, got) == port[0][:10]


def test_resolve_flow_reads_the_reference_overrides(monkeypatch):
    monkeypatch.setenv("TPU_APEX_FLOW_LOCAL_POLICY", "shed")
    monkeypatch.setenv("TPU_APEX_FLOW_FEEDER_RING", "7")
    monkeypatch.setenv("TPU_APEX_FLOW_MAX_PENDING_ROWS", "100")
    got, want = flow.resolve_flow(), jflow.resolve_flow()
    for f in ("enabled", "local_policy", "feeder_ring", "max_pending_rows"):
        assert getattr(got, f) == getattr(want, f), f
    monkeypatch.setenv("TPU_APEX_FLOW", "0")
    assert not flow.resolve_flow().enabled


def test_block_leaves_the_feeder_output_unchanged(monkeypatch):
    monkeypatch.setenv("TPU_APEX_TRACE", "0")
    q = queue.Queue()
    f = QueueFeeder(q, chunk=4)
    f.configure_flow(None)  # the default: block
    assert f._flow_ring is None
    rows = [Transition(**_kw(i), prov=_prov(i)) for i in range(10)]
    for t in rows:
        f.feed(t)
    f.flush()
    got = []
    while not q.empty():
        c = q.get_nowait()
        assert type(c) is list
        got.extend(c)
    assert all(a is b for a, b in zip(got, rows)) and len(got) == 10


def test_shed_feeder_never_stalls(monkeypatch):
    monkeypatch.setenv("TPU_APEX_FLOW_LOCAL_POLICY", "shed")
    monkeypatch.setenv("TPU_APEX_FLOW_FEEDER_RING", "2")
    q = queue.Queue(1)
    f = QueueFeeder(q, chunk=2)
    f.configure_flow(None)
    for i in range(20):  # 10 flushes into a queue of one chunk
        f.feed(Transition(**_kw(i), prov=make_prov(3, 0, 1, i)))
    ring = f._flow_ring
    assert q.qsize() == 1 and len(ring) == 2
    assert ring.dropped_chunks == 7 and f.flow_dropped_rows == 14
    assert ring.dropped_by_actor == {3: 14}
    first = q.get_nowait()
    assert isinstance(first, tracing.TracedChunk)
    assert [int(t.prov[3]) for t in first] == [0, 1]


def test_ingest_pending_bound_sheds_the_oldest(monkeypatch):
    monkeypatch.setenv("TPU_APEX_FLOW_LOCAL_POLICY", "shed")
    monkeypatch.setenv("TPU_APEX_FLOW_MAX_PENDING_ROWS", "30")
    ingest = DevicePerIngest(128, FRAME, in_process=True)
    ingest.attach("cpu")
    feeder = ingest.make_feeder(chunk=10)
    for i in range(70):
        feeder.feed(Transition(**_kw(i), prov=make_prov(i % 2, 0, 1, i)))
    fed = ingest.drain()
    shed = ingest.flow_counters["shed_rows"]
    assert fed == 30 and shed == 40 and fed + shed == 70
    assert ingest.flow_counters["shed_by_actor:0"] == 20
    # the newest rows won
    assert sorted(ingest.replay.state.prov[:30, 3].tolist()) == list(
        range(40, 70))


# -- the gateway's plane: one injected clock and one pressure trace ----------------

class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _params(mod, **kw):
    from pytorch_distributed_tpu.config import FlowParams as JFP
    from pytorch_distributed_tpu_torch.config import FlowParams as PFP

    return (PFP if mod is flow else JFP)(**kw)


def test_the_dcn_flow_fields_are_the_reference_defaults():
    from pytorch_distributed_tpu.config import FlowParams as JFP
    from pytorch_distributed_tpu_torch.config import FlowParams as PFP

    import dataclasses
    ref = {f.name: f.default for f in dataclasses.fields(JFP)}
    ours = {f.name: f.default for f in dataclasses.fields(PFP)}
    assert ours == ref
    assert flow.STATE_CODE == jflow.STATE_CODE


def test_token_buckets_step_alike():
    clocks = [_Clock(), _Clock()]
    buckets = [m.TokenBucket(5.0, 3.0, clock=c)
               for m, c in zip((flow, jflow), clocks)]
    rng = np.random.default_rng(0)
    for _ in range(200):
        dt, n = float(rng.uniform(0, 0.4)), float(rng.choice([0.5, 1, 2]))
        outs = []
        for b, c in zip(buckets, clocks):
            c.t += dt
            outs.append((b.take(n), b.level()))
        assert outs[0] == outs[1]


# a pressure trace that climbs, holds in the band, sheds long enough for
# every brownout rung, and recovers
_TRACE = ([0.2] * 4 + [0.8] * 12 + [0.6] * 6 + [0.95] * 40
          + [0.7] * 8 + [0.3] * 40)


def test_overload_governors_step_alike():
    kw = dict(dwell_s=1.0, recover_s=3.0, brownout_dwell_s=2.0)
    clocks = [_Clock(), _Clock()]
    govs = [m.OverloadGovernor(_params(m, **kw), clock=c)
            for m, c in zip((flow, jflow), clocks)]
    seen = set()
    for p in _TRACE:
        outs = []
        for g, c in zip(govs, clocks):
            c.t += 0.5
            ret = g.update(p)
            outs.append((ret, g.state, g.tier, g.transitions))
        assert outs[0] == outs[1]
        seen.add((outs[0][1], outs[0][2]))
    assert {("throttled", 0), ("shedding", 1), ("shedding", 3),
            ("healthy", 0)} <= seen


def test_gateway_flows_step_alike():
    kw = dict(dwell_s=1.0, recover_s=3.0, brownout_dwell_s=1.0,
              bucket_rate=4.0, bucket_burst=6.0, credits_throttled=4)
    pressure = {"p": 0.0}
    clocks = [_Clock(), _Clock()]
    flows = [m.GatewayFlow(_params(m, **kw), pressure=lambda: pressure["p"],
                           clock=c)
             for m, c in zip((flow, jflow), clocks)]
    rng = np.random.default_rng(1)
    minted = {0: 0, 1: 0}
    for step, p in enumerate(_TRACE * 2):
        pressure["p"] = p
        slot = int(rng.integers(0, 2))
        # a burst of chunks a step outruns the bucket's refill
        sizes = [int(r) for r in rng.integers(1, 9, int(rng.integers(1, 5)))]
        minted[slot] += sum(sizes)
        outs = []
        for f, c in zip(flows, clocks):
            c.t += 0.3
            ok = []
            for rows in sizes:
                ok.append(f.admit(slot, rows, nbytes=100 * rows))
                if ok[-1]:
                    f.note_ingested_bytes(100 * rows)
                    f.note_ingested(rows)
            if step % 5 == 0:
                f.note_rejected_bytes(7)
            f.on_client_report(slot, {"minted": minted[slot],
                                      "acked_bytes": 0, "dropped": 0,
                                      "buffered": 0})
            outs.append((ok, f.grant(slot), f.grant(1 - slot),
                         f.governor.state, f.governor.tier))
        assert outs[0] == outs[1]
    blocks = [f.status_block(quarantined=3) for f in flows]
    assert blocks[0] == blocks[1]
    cons = blocks[0]["conservation"]
    assert cons["shed_gateway"] > 0  # tier 3 shed with dry buckets
    assert cons["minted"] == sum(minted.values())
    assert cons["ingested"] + cons["shed_gateway"] == sum(minted.values())
