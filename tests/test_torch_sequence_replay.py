"""The port's segment plane against the JAX package's: the builder, the
host segment ring, the device segment ring and its fused step, and their
snapshots:

- ``SegmentBuilder`` on one push stream (overlapping windows, an episode's
  end with its padded and masked tail, a truncation, the stored carry,
  provenance), frame-packed and unpacked, against the reference's
  builder: every segment equal to the bit;
- ``SequenceReplay``: the same feeds, write-backs and draws from the same
  numpy generator (alpha 0.9 and 0): indices, rows and IS weights equal
  to the bit, and the snapshot's every key;
- ``seq_feed`` / ``seq_sample`` / ``seq_update_priorities`` on the same
  rows and the uniforms ``jax.random.uniform`` draws from the reference's
  keys: indices and rows exact, IS weights within rtol 1e-6, priorities
  and their running max within rtol 1e-6, new rows at the max, a skipped
  write-back changing nothing;
- the fused dispatch of K = 3 sub-steps against the reference's scanned
  one on the same ring, weights and keys (lr 1e-3): the params within lr
  (Adam's normalised step of a gradient element near its epsilon), the
  Adam moments within rtol 1e-4 and atol 2e-5 (mu) and 1e-6 (nu), the
  ring's priorities within rtol 1e-4;
- snapshot and restore of the device ring (a wrapped ring, restored in
  age order), across the two rings both ways, and the reference's
  snapshot into the port's ring;
- ``DeviceSequenceIngest``: chunked drains at the reference's chunk sizes
  through a feeder, the remainder left pending until a snapshot."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pytorch_distributed_tpu.memory import device_sequence as jds
from pytorch_distributed_tpu.memory import sequence_replay as jsr
from pytorch_distributed_tpu.models.drqn import DrqnMlpModel as JaxMlp
from pytorch_distributed_tpu.ops import losses as jlosses
from pytorch_distributed_tpu.ops import sequence_losses as jsl
from pytorch_distributed_tpu_torch.convert import convert_drqn
from pytorch_distributed_tpu_torch.memory import device_sequence as ds
from pytorch_distributed_tpu_torch.memory.sequence_replay import (
    Segment, SegmentBuilder, SequenceReplay,
)
from pytorch_distributed_tpu_torch.models.drqn import DrqnMlpModel
from pytorch_distributed_tpu_torch.ops.losses import (
    SKIPPED_KEY, init_train_state, make_optimizer,
)
from pytorch_distributed_tpu_torch.ops.sequence_losses import (
    build_drqn_train_step,
)
from pytorch_distributed_tpu_torch.utils.experience import make_prov

T, S, L = 4, (3,), 4  # seq_len, state_shape, lstm_dim


def _stacked_episode(n, C=4, H=6, W=6, seed=0):
    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 255, (H, W)).astype(np.uint8)
              for _ in range(n + 1)]
    return [np.stack([frames[max(0, t - C + 1 + i)] for i in range(C)])
            for t in range(n + 1)]


def _push_stream(builder_cls, pack: bool):
    """One env's pushes: 11 steps with a death at step 6 and a
    truncation at step 10."""
    C = 4
    stacks = _stacked_episode(12, C=C)
    kw = dict(state_dtype=np.uint8, pack_frames=C) if pack else dict(
        state_dtype=np.uint8)
    b = builder_cls(6, 3, **kw)
    rng = np.random.default_rng(1)
    out = []
    for t in range(11):
        ends = t in (6, 10)
        carry = (np.full(L, t, np.float32), np.full(L, -t, np.float32))
        out += b.push(stacks[t], int(rng.integers(3)), float(rng.normal()),
                      t == 6, stacks[t + 1], carry, episode_end=ends,
                      prov=make_prov(0, 1, 2, t))
        if ends:
            b.reset()
    return out


@pytest.mark.parametrize("pack", [False, True])
def test_segment_builder_streams_match_jax(pack):
    mine = _push_stream(SegmentBuilder, pack)
    ref = _push_stream(jsr.SegmentBuilder, pack)
    assert len(mine) == len(ref) == 3
    for a, b in zip(mine, ref):
        for f in jsr.Segment._fields:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)
    # the truncated tail is no death but ends its segment
    assert not mine[-1].terminal.any() and mine[-1].mask.sum() < 6
    assert mine[1].terminal.max() == 1.0


def _seg(v: float, cls=Segment) -> Segment:
    # distinct observations a step, so that no gradient of the fused
    # dispatch's update sits near zero, where Adam's normalised step
    # would magnify rounding into a step of the order of lr
    noise = np.random.default_rng(int(v)).normal(size=(T + 1, *S))
    return cls(obs=(v + noise).astype(np.float32),
               action=(np.arange(T) % 2).astype(np.int32),
               reward=np.full(T, v, np.float32),
               terminal=np.zeros(T, np.float32),
               mask=np.ones(T, np.float32),
               c0=np.full(L, v, np.float32), h0=np.full(L, -v, np.float32),
               prov=make_prov(0, 0, 0, int(v)))


@pytest.mark.parametrize("alpha", [0.9, 0.0])
def test_host_ring_draws_match_jax(alpha):
    kw = dict(priority_exponent=alpha, importance_weight=0.6,
              importance_anneal_steps=50)
    mine, ref = SequenceReplay(8, T, S, L, **kw), jsr.SequenceReplay(
        8, T, S, L, **kw)
    for i in range(11):  # wraps
        mine.feed(_seg(float(i)))
        ref.feed(_seg(float(i), jsr.Segment))
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    for k in range(3):
        a, b = mine.sample(6, r1), ref.sample(6, r2)
        for f in jsr.SegmentBatch._fields:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)
        td = np.abs(np.random.default_rng(k).normal(size=6)) * 3
        mine.update_priorities(a.index, td)
        ref.update_priorities(b.index, td)
    np.testing.assert_array_equal(mine.provenance_of(a.index),
                                  ref.provenance_of(b.index))
    snap, want = mine.snapshot(), ref.snapshot()
    assert snap.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(snap[k], want[k], err_msg=k)
    again = SequenceReplay(8, T, S, L, **kw)
    assert again.restore(want) == 8
    for k, v in again.snapshot().items():
        # the running max goes through ** alpha and back: an ulp
        np.testing.assert_allclose(v, want[k], rtol=1e-12, err_msg=k)


def _chunk(vals, cls=ds.SegmentChunk):
    segs = [_seg(float(v)) for v in vals]
    return cls(*(np.stack([getattr(s, f) for s in segs])
                 for f in cls._fields))


def _rings(capacity=8, alpha=0.9):
    kw = dict(priority_exponent=alpha, importance_weight=0.5,
              importance_anneal_steps=100)
    mine = ds.DeviceSequenceReplay(capacity, T, S, L,
                                   state_dtype=torch.float32, **kw)
    ref = jds.DeviceSequenceReplay(capacity, T, S, L,
                                   state_dtype=np.float32, **kw)
    for vals in (range(5), range(5, 11)):  # wraps
        mine.feed_chunk(_chunk(vals))
        ref.feed_chunk(_chunk(vals, jds.SegmentChunk))
    return mine, ref


def _same_ring(mine, ref, rtol=1e-6) -> None:
    st = ref.state
    for f in ds.FIELDS:
        np.testing.assert_array_equal(getattr(mine.state, f).numpy(),
                                      np.asarray(getattr(st, f)), err_msg=f)
    np.testing.assert_allclose(mine.state.priority.numpy(),
                               np.asarray(st.priority), rtol=rtol)
    np.testing.assert_allclose(float(mine.state.max_priority),
                               float(st.max_priority), rtol=rtol)
    assert mine.state.pos == int(st.pos) and mine.state.fill == int(st.fill)


def test_device_ring_feed_sample_writeback_match_jax():
    mine, ref = _rings()
    _same_ring(mine, ref)
    for k in range(4):
        key = jax.random.PRNGKey(k)
        b_ref = jds.seq_sample(ref.state, key, 5, jnp.float32(0.7))
        u = torch.from_numpy(np.array(jax.random.uniform(key, (5,))))
        b = ds.seq_sample(mine.state, u, 0.7)
        np.testing.assert_array_equal(b.index.numpy(),
                                      np.asarray(b_ref.index))
        for f in ds.FIELDS:
            np.testing.assert_array_equal(getattr(b, f).numpy(),
                                          np.asarray(getattr(b_ref, f)))
        np.testing.assert_allclose(b.weight.numpy(), np.asarray(b_ref.weight),
                                   rtol=1e-6)
        td = np.abs(np.random.default_rng(k).normal(size=5)).astype(
            np.float32) * 4
        ref.state = jds.seq_update_priorities(ref.state, b_ref.index,
                                              jnp.asarray(td), ref.alpha)
        ds.seq_update_priorities(mine.state, b.index, torch.from_numpy(td),
                                 mine.alpha)
        _same_ring(mine, ref)
    # new rows enter at the running max
    mine.feed_chunk(_chunk([42]))
    ref.feed_chunk(_chunk([42], jds.SegmentChunk))
    _same_ring(mine, ref)
    assert float(mine.state.priority[(mine.state.pos - 1) % 8]) == float(
        mine.state.max_priority)
    # a skipped write-back changes nothing
    before = mine.state.priority.clone(), mine.state.max_priority.clone()
    ds.seq_update_priorities(mine.state, torch.tensor([0, 1]),
                             torch.tensor([9.0, 9.0]), mine.alpha,
                             skipped=torch.tensor(1.0))
    assert torch.equal(mine.state.priority, before[0])
    assert torch.equal(mine.state.max_priority, before[1])


def test_fused_dispatch_matches_jax():
    mine, ref = _rings()
    jmodel = JaxMlp(action_space=2, hidden_dim=16, lstm_dim=L)
    jp = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, *S)))
    kw = dict(burn_in=1, nstep=2, target_model_update=100)
    jtx = jlosses.make_optimizer(1e-3)
    jfused = ref.build_fused_step(
        jsl.build_drqn_train_step(jmodel.apply, jtx, **kw), batch_size=4,
        donate=False, steps_per_call=3)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    jts, jrs, jm = jfused(jlosses.init_train_state(jp, jtx), ref.state,
                          keys, jnp.float32(0.5))
    model = DrqnMlpModel(2, 3, 16, L, init_weights=False)
    fused = mine.build_fused_step(
        build_drqn_train_step(model, make_optimizer(1e-3), **kw),
        batch_size=4, steps_per_call=3)
    us = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, (4,)))
                                    for k in keys]))
    ts, m = fused(init_train_state(convert_drqn(jp)), mine.state, us, 0.5)
    assert int(ts.step) == int(jts.step) == 3
    assert float(m[SKIPPED_KEY]) == float(jm[SKIPPED_KEY]) == 0.0
    np.testing.assert_allclose(float(m["learner/critic_loss"]),
                               float(jm["learner/critic_loss"]), rtol=1e-4)
    # Adam's step lr * m / (sqrt(v) + 1e-8) of an element whose gradient
    # is near 1e-8 (a ReLU unit all but dead on these rows) turns fp32
    # rounding into up to lr, so the params are held to lr; the next
    # sub-steps' gradients see those params, so the moments of the third
    # are held to 2e-5 (mu, of elements up to 0.5) and 1e-6 (nu)
    adam = jts.opt_state[0][0]
    for mine_t, ref_t, atol in ((ts.opt_state.mu, adam.mu, 2e-5),
                                (ts.opt_state.nu, adam.nu, 1e-6),
                                (ts.params, jts.params, 1e-3)):
        want = convert_drqn(jax.tree_util.tree_map(np.asarray, ref_t))
        for k, v in want.items():
            np.testing.assert_allclose(mine_t[k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=atol, err_msg=k)
    np.testing.assert_allclose(mine.state.priority.numpy(),
                               np.asarray(jrs.priority), rtol=1e-4)
    with pytest.raises(ValueError, match="megabatch"):
        mine.build_fused_step(None, 4, steps_per_call=4, megabatch=2)


def test_device_ring_snapshots_restore_across_rings():
    mine, ref = _rings()
    ds.seq_update_priorities(mine.state, torch.tensor([2, 3]),
                             torch.tensor([7.0, 3.0]), mine.alpha)
    ref.state = jds.seq_update_priorities(ref.state, jnp.asarray([2, 3]),
                                          jnp.asarray([7.0, 3.0]),
                                          ref.alpha)
    snap, want = mine.snapshot(), ref.snapshot()
    assert snap.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(snap[k], want[k], rtol=1e-6, err_msg=k)
    assert snap["reward"][0, 0] == 3.0  # the oldest surviving row
    # the port's ring from its own snapshot and from the reference's
    for data in (snap, want):
        again = ds.DeviceSequenceReplay(8, T, S, L, state_dtype=torch.float32,
                                        priority_exponent=0.9)
        assert again.restore(data) == 8
        for k, v in again.snapshot().items():
            np.testing.assert_allclose(v, snap[k], rtol=1e-6, err_msg=k)
    # the host ring restores the device ring's rows, and back
    host = SequenceReplay(8, T, S, L, priority_exponent=0.9)
    assert host.restore(snap) == 8
    back = ds.DeviceSequenceReplay(8, T, S, L, state_dtype=torch.float32,
                                   priority_exponent=0.9)
    back.restore(host.snapshot())
    for k, v in back.snapshot().items():
        np.testing.assert_allclose(v, snap[k], rtol=1e-6, err_msg=k)


def test_ingest_drains_in_chunks():
    ing = ds.DeviceSequenceIngest(16, T, S, L, state_dtype=np.float32,
                                  chunk_size=4, in_process=True)
    feeder = ing.make_feeder(chunk=2)
    ing.attach("cpu")
    assert ing.chunk_sizes == (16, 4)
    for i in range(9):
        feeder.feed(_seg(float(i)))
    feeder.flush()
    assert ing.drain() == 8  # two chunks of 4; one segment stays pending
    assert ing.size == 8 and len(ing._pending) == 1
    snap = ing.snapshot()  # the remainder goes in first
    np.testing.assert_array_equal(snap["c0"][:, 0], np.arange(9.0))
    assert ing.size == 9 and ing.validated == 9
    ing2 = ds.DeviceSequenceIngest(16, T, S, L, state_dtype=np.float32,
                                   in_process=True)
    ing2.attach("cpu")
    assert ing2.restore(snap) == 9 and ing2.size == 9
    assert ing2.xray()["rows"] == 9
