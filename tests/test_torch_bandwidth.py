"""The port's bandwidth X-ray (utils/bandwidth.py) against the JAX
package's, on the CPU:

- ``payload_nbytes`` and ``chunk_nbytes`` of the same chunk (the
  reference's ``(Transition, priority)`` pairs, the port's bare
  Transitions, provenance included) are equal;
- ``replay_nbytes`` and ``note_device_replay``'s gauges of the port's
  device rings equal the reference's for the same geometry, field by
  field, ``prov`` (and the PER ring's priorities) included;
- ``note_host_replay`` of the prioritized host ring, with its sidecar;
- ``emit_scalars`` equals the reference's for the same note sequence
  under an injected clock, and ``totals``/``snapshot`` agree;
- the spawn link through a feeder and its queue: bytes minted equal
  bytes drained when every row is read, and ``TPU_APEX_WIRE=0`` turns
  the plane off."""

import numpy as np
import pytest

from pytorch_distributed_tpu.config import (
    BandwidthParams as JaxBandwidthParams,
)
from pytorch_distributed_tpu.memory import device_per as jper
from pytorch_distributed_tpu.memory import device_replay as jrep
from pytorch_distributed_tpu.memory.prioritized import (
    PrioritizedReplay as JaxPrioritized,
)
from pytorch_distributed_tpu.utils import bandwidth as jbw
from pytorch_distributed_tpu.utils import experience as jexp
from pytorch_distributed_tpu_torch.config import BandwidthParams
from pytorch_distributed_tpu_torch.memory.device_per import DevicePerReplay
from pytorch_distributed_tpu_torch.memory.device_replay import (
    DevicePerIngest, DeviceReplay,
)
from pytorch_distributed_tpu_torch.memory.prioritized import (
    PrioritizedReplay,
)
from pytorch_distributed_tpu_torch.utils import bandwidth
from pytorch_distributed_tpu_torch.utils.experience import (
    Transition, make_prov,
)

FRAME = (4, 84, 84)


@pytest.fixture(autouse=True)
def _fresh_planes():
    bandwidth.reset_for_tests()
    jbw.reset_for_tests()
    yield
    bandwidth.reset_for_tests()
    jbw.reset_for_tests()


def _kw(rng, i):
    return dict(state0=rng.integers(0, 255, FRAME).astype(np.uint8),
                action=np.int32(i % 6), reward=np.float32(rng.normal()),
                gamma_n=np.float32(0.95), terminal1=np.float32(0.0),
                state1=rng.integers(0, 255, FRAME).astype(np.uint8))


def test_chunk_bytes_equal_the_reference():
    rng = np.random.default_rng(0)
    kws = [_kw(rng, i) for i in range(16)]
    provs = [make_prov(1, i % 4, 3, 77) if i % 3 else None
             for i in range(16)]
    port = [Transition(**kw, prov=p) for kw, p in zip(kws, provs)]
    ref = [(jexp.Transition(**kw, prov=p), 0.5 if i % 2 else None)
           for i, (kw, p) in enumerate(zip(kws, provs))]
    got = bandwidth.chunk_nbytes(port)
    assert got == jbw.chunk_nbytes(ref) == jbw.payload_nbytes(ref)
    assert got == bandwidth.payload_nbytes(port)
    # two frames, the four scalars and 32 bytes of provenance on 2 rows of 3
    assert got == 16 * (2 * 28224 + 4 * 4) + 10 * 32


@pytest.mark.parametrize("per", [False, True], ids=["uniform", "per"])
@pytest.mark.parametrize("capacity", [7, 5000])
def test_ring_bytes_equal_the_reference(per, capacity):
    ring = (DevicePerReplay if per else DeviceReplay)(capacity, FRAME)
    jring = (jper.DevicePerReplay if per else jrep.DeviceReplay)(capacity,
                                                                 FRAME)
    got = bandwidth.ring_field_nbytes(ring.state)
    want = bandwidth.ring_field_nbytes(jring.state)
    assert got == want
    assert got["prov"] == capacity * 16
    assert bandwidth.replay_nbytes(ring.state) == jbw.replay_nbytes(
        jring.state)
    acct, jacct = bandwidth.get_accountant(), jbw.get_accountant()
    bandwidth.note_device_replay(ring.state, ring.state)
    jbw.note_device_replay(jring.state, jring.state)
    assert acct._gauges == jacct._gauges
    assert acct._gauges["replay/hbm_bytes"] == 2 * sum(got.values())


def test_attach_gauges_the_ring():
    ingest = DevicePerIngest(300, FRAME, in_process=True)
    ingest.attach("cpu")
    want = jbw.replay_nbytes(jper.DevicePerReplay(300, FRAME).state)
    assert bandwidth.emit_scalars()["replay/hbm_bytes"] == want
    ingest.attach_halves("cpu")
    half = jbw.replay_nbytes(jper.DevicePerReplay(150, FRAME).state)
    assert bandwidth.emit_scalars()["replay/hbm_bytes"] == 2 * half


def test_host_ring_gauge_equals_the_reference():
    PrioritizedReplay(64, FRAME)
    JaxPrioritized(64, FRAME)
    assert bandwidth.get_accountant()._gauges == jbw.get_accountant()._gauges
    assert bandwidth.get_accountant()._gauges["replay/host_bytes/prov"] \
        == 64 * 32


def test_emit_scalars_equals_the_reference():
    acct = bandwidth.LinkAccountant(BandwidthParams())
    jacct = jbw.LinkAccountant(JaxBandwidthParams())
    rng = np.random.default_rng(1)
    t = 100.0
    for step in range(6):
        for a in (acct, jacct):
            a.set_gauge("replay/hbm_bytes", 1234.0 + step)
        for _ in range(5):
            verb = ("mint", "drain")[int(rng.integers(2))]
            nb, frames = int(rng.integers(1, 10 ** 6)), int(rng.integers(1, 4))
            for a in (acct, jacct):
                a.note("spawn", verb, nb, "tx" if verb == "mint" else "rx",
                       frames=frames)
        if step >= 2:  # a gateway's ingest: bytes per transition
            for a in (acct, jacct):
                a.note("gateway", "exp", 5000 * step, "rx", slot=step % 2)
                a.note_transitions(10 * step)
        t += float(rng.choice([0.01, 0.5, 2.0]))  # one emit under the floor
        assert acct.emit_scalars(now=t) == jacct.emit_scalars(now=t)
    assert acct.totals("spawn", "mint") == jacct.totals("spawn", "mint")
    assert acct.totals(direction="rx") == jacct.totals(direction="rx")
    assert acct.snapshot() == jacct.snapshot()
    assert acct.bytes_per_transition() == jacct.bytes_per_transition() > 0


def test_spawn_link_conserves_through_the_queue():
    ingest = DevicePerIngest(256, FRAME, in_process=True)
    ingest.attach("cpu")
    feeder = ingest.make_feeder(chunk=8)
    rng = np.random.default_rng(2)
    for i in range(40):
        feeder.feed(Transition(**_kw(rng, i), prov=make_prov(0, i % 2, 1, 0)))
    feeder.flush()
    assert ingest.drain() == 40
    acct = bandwidth.get_accountant()
    minted, frames = acct.totals("spawn", "mint", "tx")
    drained, dframes = acct.totals("spawn", "drain", "rx")
    assert minted == drained == 40 * (2 * 28224 + 16 + 32)
    assert frames == dframes == 5
    assert "wire/spawn/bytes_per_s" not in acct.emit_scalars(now=0.0)
    assert acct.emit_scalars(now=1.0)["wire/spawn/bytes_per_s"] == 0.0


def test_wire_off_turns_the_plane_off(monkeypatch):
    monkeypatch.setenv("TPU_APEX_WIRE", "0")
    monkeypatch.setenv("TPU_APEX_WIRE_RATE_FLOOR_S", "0.5")
    got, want = bandwidth.resolve_bandwidth(), jbw.resolve_bandwidth()
    assert (got.enabled, got.spawn, got.rate_floor_s) == (
        want.enabled, want.spawn, want.rate_floor_s) == (False, True, 0.5)
    assert bandwidth.get_accountant() is None and not bandwidth.enabled()
    bandwidth.note_spawn("mint", [1, 2])
    assert bandwidth.emit_scalars() == {}
