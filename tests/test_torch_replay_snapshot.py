"""The prioritized ring's checkpoint surface (memory/device_per.py,
memory/device_replay.py ``snapshot``/``restore``) against the JAX
package's ``DevicePerReplay``: the same rows and the same priority
write-backs into both rings give equal snapshots, array for array (the
JAX package's ``prov`` column left out), before and after the ring
wraps; the JAX snapshot restored into the port snapshots back to the
same arrays; a smaller ring keeps the newest rows; the ingest drains its
queued chunks before it snapshots; and a changed row shape or dtype
raises ``CheckpointMismatch``.  All exact.

The write-backs hand both rings the same stored ``p ** alpha`` values:
torch's and XLA's float32 ``pow`` differ in the last bit on some inputs,
which is not what this test holds."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorch_distributed_tpu.memory.device_per import (
    DevicePerReplay as JaxDevicePerReplay,
)
from pytorch_distributed_tpu.utils.experience import (
    Transition as JaxTransition,
)
from pytorch_distributed_tpu_torch.memory.device_per import DevicePerReplay
from pytorch_distributed_tpu_torch.memory.device_replay import (
    DevicePerIngest,
)
from pytorch_distributed_tpu_torch.utils import checkpoint as ckpt
from pytorch_distributed_tpu_torch.utils.experience import (
    REPLAY_FIELDS, Transition,
)

FRAME, CAPACITY, ALPHA = (2, 6, 6), 40, 0.6


def _chunk(rng, n):
    return dict(
        state0=rng.integers(0, 255, (n, *FRAME)).astype(np.uint8),
        action=rng.integers(0, 6, n).astype(np.int32),
        reward=rng.normal(size=n).astype(np.float32),
        gamma_n=np.full(n, 0.99 ** 3, np.float32),
        state1=rng.integers(0, 255, (n, *FRAME)).astype(np.uint8),
        terminal1=(rng.random(n) < 0.2).astype(np.float32))


def _write_back(port, jax_ring, idx, pr):
    """One priority write-back of stored values into both rings, with the
    running max, as ``per_update_priorities`` leaves them."""
    st = port.state
    st.priority[torch.as_tensor(idx).long()] = torch.as_tensor(pr)
    st.max_priority.copy_(torch.maximum(st.max_priority,
                                        torch.as_tensor(pr).max()))
    js = jax_ring.state
    jax_ring.state = js._replace(
        priority=js.priority.at[jnp.asarray(idx)].set(jnp.asarray(pr)),
        max_priority=jnp.maximum(js.max_priority, jnp.asarray(pr).max()))


def _twin_rings(chunks):
    rng = np.random.default_rng(3)
    port = DevicePerReplay(CAPACITY, FRAME, priority_exponent=ALPHA)
    jax_ring = JaxDevicePerReplay(CAPACITY, FRAME, priority_exponent=ALPHA)
    for n in chunks:
        cols = _chunk(rng, n)
        port.feed_chunk(Transition(**cols))
        jax_ring.feed_chunk(JaxTransition(**cols))
        fill = port.state.fill
        idx = np.unique(rng.integers(0, fill, 6)).astype(np.int32)
        pr = (rng.random(len(idx)) * 4.0 + 0.01).astype(np.float32)
        _write_back(port, jax_ring, idx, pr)
    return port, jax_ring


def _assert_equal(got: dict, want: dict):
    assert set(got) == set(want) - {"prov"}
    for k in got:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        assert np.array_equal(got[k], want[k]), k


# filling, exactly full, and wrapped twice with the cursor mid-ring
@pytest.mark.parametrize("chunks", [(7, 12), (20, 20), (30, 25, 17, 9)])
def test_snapshot_matches_the_reference(chunks):
    port, jax_ring = _twin_rings(chunks)
    want = jax_ring.snapshot()
    _assert_equal(port.snapshot(), want)
    assert len(want["reward"]) == min(sum(chunks), CAPACITY)
    # the reference's snapshot, prov and all, restores into the port
    back = DevicePerReplay(CAPACITY, FRAME, priority_exponent=ALPHA)
    assert back.restore(want) == len(want["reward"])
    _assert_equal(back.snapshot(), want)
    assert float(back.state.fill_rows) == back.state.fill


def test_restore_keeps_the_newest_rows_that_fit():
    port, _ = _twin_rings((30, 25))
    snap = port.snapshot()
    small = DevicePerReplay(16, FRAME, priority_exponent=ALPHA)
    small.feed_chunk(Transition(**_chunk(np.random.default_rng(0), 5)))
    assert small.restore(snap) == 16  # replaces what was there
    got = small.snapshot()
    for k in REPLAY_FIELDS + ("leaf_priority",):
        assert np.array_equal(got[k], snap[k][-16:]), k
    assert got["max_priority_base"] == snap["max_priority_base"]


def test_ingest_drains_its_queue_before_the_snapshot():
    rng = np.random.default_rng(5)
    ingest = DevicePerIngest(CAPACITY, FRAME, in_process=True)
    ingest.attach("cpu")
    feeder = ingest.make_feeder(chunk=4)
    cols = _chunk(rng, 22)
    for i in range(22):
        feeder.feed(Transition(**{k: v[i] for k, v in cols.items()}))
    feeder.flush()
    assert ingest.replay.state.fill == 0  # nothing drained yet
    snap = ingest.snapshot()
    assert len(snap["reward"]) == ingest.size == 22
    for k in REPLAY_FIELDS:
        assert np.array_equal(snap[k], cols[k]), k
    other = DevicePerIngest(CAPACITY, FRAME, in_process=True)
    other.attach("cpu")
    assert other.restore(snap) == 22 and other.size == 22
    _assert_equal(other.snapshot(), snap)


@pytest.mark.parametrize("field,value", [
    ("state0", np.zeros((3, 2, 6, 7), np.uint8)),
    ("state0", np.zeros((3, *FRAME), np.float32)),
])
def test_a_changed_geometry_raises(tmp_path, field, value):
    port, _ = _twin_rings((10,))
    snap = dict(port.snapshot())
    snap = {k: v[:3] if np.ndim(v) else v for k, v in snap.items()}
    snap[field] = value
    with pytest.raises(ckpt.CheckpointMismatch, match="state"):
        ckpt.validate_snapshot(port, snap)
    name = str(tmp_path / "run")

    class Frozen:  # a memory whose snapshot is the damaged one
        def snapshot(self):
            return snap

    ckpt.save_epoch(name, memory=Frozen(), extras={"learner_step": 1})
    with pytest.raises(ckpt.CheckpointMismatch):
        ckpt.load_epoch_replay(ckpt.resolve_epoch(name), port)
