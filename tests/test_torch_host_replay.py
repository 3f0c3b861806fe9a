"""The port's host replay (utils/segment_tree.py, memory/shared_replay.py,
memory/prioritized.py, memory/feeder.py ``QueueOwner``,
memory/native_ring.py) against the JAX package's, on the same numpy
transitions and identically seeded numpy generators: the host paths are
exact, so every comparison is to the bit.

- ``SumTree`` / ``MinTree``: the same sets give the same tree arrays,
  prefix-sum descents and stratified draws;
- ``SharedReplay`` and ``PrioritizedReplay`` (wrapped by ``QueueOwner``
  on both sides, fed through the queues): identical indices, batches, IS
  weights and priorities, also after |TD| write-backs and with wrap-around;
- the queues of ``QueueOwner``: per slot across a spawn context's queues,
  the quarantine of a NaN row;
- snapshot and restore round trips, also from the JAX package's
  snapshots;
- the native ring (``native/ring_buffer.cpp``, built with g++) against
  ``SharedReplay``;
- both host rings survive a spawn pickle with their shared pages."""

import multiprocessing as mp
import time

import numpy as np
import pytest

from pytorch_distributed_tpu.memory.feeder import QueueOwner as JaxOwner
from pytorch_distributed_tpu.memory.prioritized import (
    PrioritizedReplay as JaxPer,
)
from pytorch_distributed_tpu.memory.shared_replay import (
    SharedReplay as JaxShared,
)
from pytorch_distributed_tpu.utils.experience import (
    Transition as JaxTransition,
)
from pytorch_distributed_tpu.utils.segment_tree import (
    MinTree as JaxMinTree, SumTree as JaxSumTree,
)
from pytorch_distributed_tpu_torch.memory.feeder import QueueOwner
from pytorch_distributed_tpu_torch.memory.native_ring import (
    NativeRingReplay,
)
from pytorch_distributed_tpu_torch.memory.prioritized import (
    PrioritizedReplay,
)
from pytorch_distributed_tpu_torch.memory.shared_replay import SharedReplay
from pytorch_distributed_tpu_torch.utils import health
from pytorch_distributed_tpu_torch.utils.experience import (
    REPLAY_FIELDS, Transition,
)
from pytorch_distributed_tpu_torch.utils.segment_tree import MinTree, SumTree

SHAPE, CAP, B = (3, 5, 5), 40, 8


def _rows(n: int, seed: int = 0, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if dtype == np.uint8:
            s0 = rng.integers(0, 255, SHAPE).astype(np.uint8)
            s1 = rng.integers(0, 255, SHAPE).astype(np.uint8)
        else:
            s0 = rng.normal(size=SHAPE).astype(np.float32)
            s1 = rng.normal(size=SHAPE).astype(np.float32)
        out.append(dict(state0=s0, action=np.int32(rng.integers(0, 6)),
                        reward=np.float32(rng.normal()),
                        gamma_n=np.float32(0.99 ** 5), state1=s1,
                        terminal1=np.float32(rng.random() < 0.2)))
    return out


def _assert_batches_equal(b, jb):
    for f in REPLAY_FIELDS + ("weight", "index"):
        a, r = np.asarray(getattr(b, f)), np.asarray(getattr(jb, f))
        assert a.dtype == r.dtype, f
        np.testing.assert_array_equal(a, r, err_msg=f)


def test_segment_trees_match_the_reference():
    rng = np.random.default_rng(0)
    trees = [(SumTree(37), JaxSumTree(37)), (MinTree(37), JaxMinTree(37))]
    for _ in range(5):
        idx = rng.integers(0, 37, 12)  # duplicates included
        pri = rng.uniform(0.0, 5.0, 12)
        for port, ref in trees:
            port.set(idx, pri)
            ref.set(idx, pri)
    for port, ref in trees:
        np.testing.assert_array_equal(port.tree, ref.tree)
    s, js = trees[0]
    values = rng.uniform(0.0, s.total, 500)
    np.testing.assert_array_equal(s.find(values), js.find(values))
    for strat in (True, False):
        np.testing.assert_array_equal(
            s.sample(64, np.random.default_rng(3), stratified=strat),
            js.sample(64, np.random.default_rng(3), stratified=strat))
    assert trees[1][0].min == trees[1][1].min


@pytest.mark.parametrize("kind", ["shared", "prioritized"])
def test_rings_sample_like_the_reference(kind):
    """Fed 55 rows (a wrap of the 40-row ring) through ``QueueOwner``'s
    queue on both sides, drawn with generators of one seed, with |TD|
    written back after every draw: every batch, weight and priority
    equal."""
    if kind == "shared":
        port = QueueOwner(SharedReplay(CAP, SHAPE), in_process=True)
        ref = JaxOwner(JaxShared(CAP, SHAPE))
    else:
        port = QueueOwner(PrioritizedReplay(CAP, SHAPE,
                                            importance_anneal_steps=10),
                          in_process=True)
        ref = JaxOwner(JaxPer(CAP, SHAPE, importance_anneal_steps=10))
    feeder, jfeeder = port.make_feeder(chunk=4), ref.make_feeder(chunk=4)
    for r in _rows(55):
        feeder.feed(Transition(**r))
        jfeeder.feed(JaxTransition(**r))
    feeder.flush()
    jfeeder.flush()
    deadline = time.monotonic() + 10.0
    while ref.size < CAP and time.monotonic() < deadline:
        ref.drain()  # its spawn queue hands chunks over from a thread
        time.sleep(0.01)
    assert port.drain() == 55
    assert port.size == ref.size == CAP
    rng, jrng = np.random.default_rng(9), np.random.default_rng(9)
    td_rng = np.random.default_rng(1)
    for _ in range(6):
        b, jb = port.sample(B, rng), ref.sample(B, jrng)
        _assert_batches_equal(b, jb)
        td = td_rng.normal(size=B)
        port.update_priorities(b.index, td)
        ref.update_priorities(jb.index, td)
    if kind == "prioritized":
        per, jper = port.memory, ref.memory
        np.testing.assert_array_equal(per.sum_tree.tree, jper.sum_tree.tree)
        np.testing.assert_array_equal(per.min_tree.tree, jper.min_tree.tree)
        assert per.max_priority == jper.max_priority
        assert per.beta == jper.beta
        np.testing.assert_array_equal(per.priority_leaves(),
                                      ref.priority_leaves())
    port.close()
    ref.close()


def test_slot_queues_and_the_quarantine(tmp_path):
    """Two actor slots on spawn-context queues; a NaN reward is diverted
    to the quarantine, the rest reach the ring in slot order."""
    from pytorch_distributed_tpu_torch.utils import flight_recorder

    flight_recorder.configure(str(tmp_path))
    health.reset()
    owner = QueueOwner(PrioritizedReplay(CAP, SHAPE), slots=2)
    rows = _rows(8, seed=2)
    rows[3]["reward"] = np.float32(np.nan)
    for slot in (0, 1):
        f = owner.make_feeder(slot, chunk=4)
        for r in rows[4 * slot:4 * slot + 4]:
            f.feed(Transition(**r))
        f.flush()
    got, deadline = 0, time.monotonic() + 10.0
    while got < 8 and time.monotonic() < deadline:
        got += owner.drain()
        time.sleep(0.01)
    assert got == 8 and owner.size == 7
    assert (owner.validated, owner.quarantined) == (8, 1)
    assert health.quarantine_counts().get("feeder-local") == 1
    good = [r for i, r in enumerate(rows) if i != 3]
    np.testing.assert_array_equal(owner.memory.reward[:7],
                                  [r["reward"] for r in good])
    owner.close()
    health.reset()


@pytest.mark.parametrize("kind", ["shared", "prioritized"])
def test_snapshot_and_restore_round_trip(kind):
    make = {"shared": (lambda: SharedReplay(CAP, SHAPE),
                       lambda: JaxShared(CAP, SHAPE)),
            "prioritized": (lambda: PrioritizedReplay(CAP, SHAPE),
                            lambda: JaxPer(CAP, SHAPE))}[kind]
    port, ref = make[0](), make[1]()
    rows = _rows(50, seed=4)
    for r in rows:
        port.feed(Transition(**r))
        ref.feed(JaxTransition(**r))
    td = np.random.default_rng(5).normal(size=B)
    port.update_priorities(np.arange(B), td)
    ref.update_priorities(np.arange(B), td)
    snap, jsnap = port.snapshot(), ref.snapshot()
    for k in snap:
        np.testing.assert_array_equal(snap[k], jsnap[k], err_msg=k)
    # into a fresh port ring, from its own snapshot and from the JAX
    # package's (whose provenance column the port ignores), and into a
    # smaller ring, which keeps the newest rows
    for data, cap in ((snap, CAP), (jsnap, CAP), (snap, 16)):
        back = make[0]() if cap == CAP else (
            SharedReplay(cap, SHAPE) if kind == "shared"
            else PrioritizedReplay(cap, SHAPE))
        assert back.restore(data) == min(cap, CAP)
        again = back.snapshot()
        for k in REPLAY_FIELDS:
            np.testing.assert_array_equal(again[k], snap[k][-cap:],
                                          err_msg=k)
        if cap == CAP:  # as the JAX package's ring restored from it
            jback = make[1]()
            jback.restore(data)
            _assert_batches_equal(back.sample(B, np.random.default_rng(2)),
                                  jback.sample(B, np.random.default_rng(2)))


def test_native_ring_against_shared_replay():
    native = NativeRingReplay(CAP, SHAPE)
    shared = SharedReplay(CAP, SHAPE)
    for r in _rows(55, seed=6):
        native.feed(Transition(**r))
        shared.feed(Transition(**r))
    assert native.size == shared.size == CAP
    assert native.total_feeds == shared.total_feeds == 55
    rng, srng = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(3):
        _assert_batches_equal(native.sample(B, rng), shared.sample(B, srng))
    assert native.sample_retries == 0


def _child_feeds(mem, rows):
    feeder = mem.make_feeder()
    for r in rows:
        feeder.feed(Transition(**r))


@pytest.mark.parametrize("kind", ["shared", "native"])
def test_host_rings_are_shared_across_a_spawn(kind):
    """A spawn child writes the ring through its feeder; the parent reads
    the rows in the same pages."""
    mem = (SharedReplay(CAP, SHAPE, state_dtype=np.float32) if kind ==
           "shared" else NativeRingReplay(CAP, SHAPE,
                                          state_dtype=np.float32))
    rows = _rows(10, seed=7, dtype=np.float32)
    p = mp.get_context("spawn").Process(target=_child_feeds,
                                        args=(mem, rows))
    p.start()
    p.join(60)
    assert p.exitcode == 0 and mem.size == 10
    b = mem.sample(10, np.random.default_rng(0))
    for i, j in enumerate(b.index):
        np.testing.assert_array_equal(b.state0[i], rows[j]["state0"])
