"""The staged drain (memory/device_replay.py ``StagedWriter``): rows
stacked into a few fixed host slabs and written to the ring slab by slab
must leave the ring exactly as the blocking ``ring_write`` of the same rows
does, and as the JAX package's ring, on the CPU path: drains smaller and
larger than a slab, across the ring's wrap, with slabs reused and a
``max_rows`` cap that leaves rows pending."""

import numpy as np
import pytest

from pytorch_distributed_tpu.memory.device_per import (
    DevicePerReplay as JaxDevicePerReplay,
)
from pytorch_distributed_tpu.utils.experience import (
    Transition as JaxTransition,
)
from pytorch_distributed_tpu_torch.memory.device_per import DevicePerReplay
from pytorch_distributed_tpu_torch.memory import device_replay
from pytorch_distributed_tpu_torch.memory.device_replay import (
    DevicePerIngest, StagedWriter,
)
from pytorch_distributed_tpu_torch.utils.experience import (
    REPLAY_FIELDS, Transition,
)

FRAME, CAPACITY = (2, 6, 6), 40
# rows per drain: under a slab, several slabs, across the wrap, a full ring
DRAINS = (5, 30, 37, 40, 3)


def _rows(n, seed):
    """Rows as the actor feeds them: uint8 frames, numpy int64 actions,
    float32 scalars."""
    rng = np.random.default_rng(seed)
    return [Transition(
        state0=rng.integers(0, 255, FRAME).astype(np.uint8),
        action=np.asarray(rng.integers(0, 6)),
        reward=np.float32(rng.normal()),
        gamma_n=np.float32(0.99 ** rng.integers(1, 6)),
        state1=rng.integers(0, 255, FRAME).astype(np.uint8),
        terminal1=np.float32(rng.random() < 0.2)) for _ in range(n)]


def _stack(rows, ctor):
    dt = dict(action=np.int32)
    return ctor(*(np.stack([np.asarray(getattr(r, f), dt.get(f))
                            for r in rows]) for f in REPLAY_FIELDS))


@pytest.mark.parametrize("stage_rows,stage_slabs",
                         [(8, 2), (8, 3), (16, 2), (64, 2)])
def test_staged_drain_writes_the_blocking_ring(monkeypatch, stage_rows,
                                               stage_slabs):
    monkeypatch.setattr(device_replay, "STAGE_ROWS", stage_rows)
    monkeypatch.setattr(device_replay, "STAGE_SLABS", stage_slabs)
    ingest = DevicePerIngest(CAPACITY, FRAME, in_process=True)
    ring = ingest.attach("cpu")
    blocking = DevicePerReplay(CAPACITY, FRAME, device="cpu")
    jring = JaxDevicePerReplay(CAPACITY, FRAME)
    feeder = ingest.make_feeder(chunk=4)
    pieces = 0
    for i, n in enumerate(DRAINS):
        rows = _rows(n, seed=i)
        for t in rows:
            feeder.feed(t)
        feeder.flush()
        assert ingest.drain() == n
        pieces += -(-n // min(stage_rows, CAPACITY))
        blocking.feed_chunk(_stack(rows, Transition))
        jring.feed_chunk(_stack(rows, JaxTransition))
        for f in REPLAY_FIELDS + ("priority",):
            got = getattr(ring.state, f).numpy()
            assert np.array_equal(got, getattr(blocking.state, f).numpy()), f
            assert np.array_equal(got, np.asarray(getattr(jring.state, f))), f
        assert (ring.state.pos, ring.state.fill) == (
            blocking.state.pos, blocking.state.fill) == (
            int(jring.state.pos), int(jring.state.fill))
        assert float(ring.state.fill_rows) == ring.state.fill
    assert ingest.size == CAPACITY
    # the slabs were taken in turn: one per slab-sized piece
    assert ingest._staging._next == pieces % stage_slabs
    assert ingest._staging.rows == min(stage_rows, CAPACITY)
    assert not ingest._staging.pinned  # a CPU ring stages in plain memory


def test_drain_caps_rows_and_keeps_the_rest_pending(monkeypatch):
    monkeypatch.setattr(device_replay, "STAGE_ROWS", 8)
    ingest = DevicePerIngest(CAPACITY, FRAME, in_process=True)
    ingest.attach("cpu")
    blocking = DevicePerReplay(CAPACITY, FRAME, device="cpu")
    feeder = ingest.make_feeder(chunk=5)
    rows = _rows(25, seed=9)
    for t in rows:
        feeder.feed(t)
    assert ingest.drain(max_rows=11) == 11
    assert ingest.drain(max_rows=11) == 11
    assert ingest.drain() == 3
    assert ingest.drain() == 0
    blocking.feed_chunk(_stack(rows, Transition))
    for f in REPLAY_FIELDS:
        assert np.array_equal(getattr(ingest.replay.state, f).numpy(),
                              getattr(blocking.state, f).numpy()), f


def test_slabs_hold_the_rings_columns():
    ring = DevicePerReplay(CAPACITY, FRAME, device="cpu")
    writer = StagedWriter(ring, rows=8, slabs=3)
    assert len(writer._slabs) == 3
    for slab in writer._slabs:
        for f in REPLAY_FIELDS:
            col = getattr(ring.state, f)
            assert slab[f].dtype == col.dtype
            assert tuple(slab[f].shape) == (8, *col.shape[1:])
