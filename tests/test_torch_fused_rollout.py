"""The port's fused device rollout (models/policies.py) and the masked ring
writes (memory/device_replay.py, memory/device_per.py) against the JAX
package's, and the ``device`` actor against the ``inline`` actor.

- Rollout against JAX: 3 envs x 5 ticks x 5 dispatches, nstep 3,
  early_stop 20 (the JAX package's own test size), the same fixed linear
  policy in both (integer weights over the raw uint8 pixels, scaled by
  2**-10: every partial sum is an integer below 2**24, so the Q-values are
  exact whatever the summation order), JAX's per-(tick, row) draws
  (``tick_keys``, split as ``_rowwise_eps_greedy`` splits them) injected
  into the torch rollout.  Tolerance: none, every column of every chunk is
  equal to the bit (uint8, int and bool columns, and the float columns:
  rewards, discounts, terminals, q_sel, q_boot), and so are
  ``rollout_priorities``.
- ``emit="replay"`` writes the ring that ``emit="chunk"`` writes through
  the ingest (feeder, queue, drain), to the bit, priorities included.
- ``ring_write_masked``/``per_write_masked`` equal JAX's on mixed masks
  across the wrap.
- The ``device`` actor over the device env gives the transitions of the
  ``inline`` actor over ``DevicePongVectorEnv`` at the same seed.
"""

import collections
import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_distributed_tpu.config import build_options as jax_options
from pytorch_distributed_tpu.envs.device_env import (
    build_device_env as jax_device_env,
)
from pytorch_distributed_tpu.memory import device_per as jper
from pytorch_distributed_tpu.memory import device_replay as jrep
from pytorch_distributed_tpu.models import policies as jpol
from pytorch_distributed_tpu.utils.experience import (
    Transition as JaxTransition,
)
from pytorch_distributed_tpu.utils.rngs import process_key
from pytorch_distributed_tpu_torch.agents import actor as actor_mod
from pytorch_distributed_tpu_torch.config import build_options
from pytorch_distributed_tpu_torch.envs.device_env import (
    DevicePongVectorEnv, build_device_env,
)
from pytorch_distributed_tpu_torch.memory.device_per import (
    DevicePerReplay, per_write_masked,
)
from pytorch_distributed_tpu_torch.memory.device_replay import (
    DevicePerIngest, DeviceReplay, ring_write_masked,
)
from pytorch_distributed_tpu_torch.models import policies as tpol
from pytorch_distributed_tpu_torch.utils.experience import (
    REPLAY_FIELDS, Transition,
)

N, NSTEP, GAMMA, K, DISPATCHES = 3, 3, 0.99, 5, 5
SCALE = 2.0 ** -10


def _weights(seed=0):
    return np.random.default_rng(seed).integers(
        -1, 2, size=(4 * 84 * 84, 6)).astype(np.float32)


def _jax_apply(p, obs):
    x = obs.reshape((obs.shape[0], -1)).astype(jnp.float32)
    return (x @ p) * np.float32(SCALE)


def _torch_apply(p, obs):
    return (obs.reshape(obs.shape[0], -1).float() @ p) * SCALE


def _jax_draws(base_key, tick: int, n: int):
    """The explore uniform and random action JAX's rollout draws for each
    row at ``tick``."""
    def row(key):
        k_explore, k_choice = jax.random.split(key)
        return (jax.random.uniform(k_explore),
                jax.random.randint(k_choice, (), 0, 6))

    u, a = jax.vmap(row)(jpol.tick_keys(base_key, tick, n))
    return np.array(u), np.asarray(a).astype(np.int64)


@pytest.fixture(scope="module")
def chunks():
    ep = build_options(12, early_stop=20).env_params
    jep = jax_options(4).env_params
    jep.early_stop = 20
    w = _weights()
    eps = jpol.apex_epsilons(0, 2, N, 0.4, 7.0)
    base_key = process_key(100, "actor", 0)
    jenv = jax_device_env(jep, 0, N)
    jroll = jpol.build_fused_rollout(_jax_apply, jenv, nstep=NSTEP,
                                     gamma=GAMMA, rollout_ticks=K,
                                     emit="chunk")
    jcarry = jpol.init_rollout_carry(jenv, NSTEP)
    roll = tpol.build_fused_rollout(_torch_apply, build_device_env(ep, 0, N),
                                    nstep=NSTEP, gamma=GAMMA,
                                    rollout_ticks=K, eps=eps)
    carry = tpol.init_rollout_carry(roll.env, NSTEP)
    tw = torch.from_numpy(w)
    out = []
    for d in range(DISPATCHES):
        jcarry, jch = jroll(jnp.asarray(w), jcarry, base_key,
                            jnp.int32(d * K), jnp.asarray(eps))
        for k in range(K):
            u, a = _jax_draws(base_key, d * K + k, N)
            roll.explore_u[k] = torch.from_numpy(u)
            roll.random_a[k] = torch.from_numpy(a)
        ch = roll(tw, carry)
        out.append((jax.device_get(jch._asdict()),
                    {f: getattr(ch, f).numpy() for f in ch._fields}))
    assert carry.ticks == DISPATCHES * K and int(carry.tick) == carry.ticks
    return out


def test_every_chunk_column_equals_jax(chunks):
    assert set(chunks[0][1]) == set(chunks[0][0])
    for d, (jch, ch) in enumerate(chunks):
        for f, col in ch.items():
            ref = np.asarray(jch[f])
            assert col.shape == ref.shape, (d, f)
            np.testing.assert_array_equal(col, ref.astype(col.dtype),
                                          err_msg=f"dispatch {d} {f}")


def test_warmup_ticks_are_invalid_then_all_valid(chunks):
    valid = chunks[0][1]["valid"]
    assert not valid[:NSTEP].any() and valid[NSTEP:].all()
    assert all(ch["valid"].all() for _j, ch in chunks[1:])
    # the run crosses truncations (early_stop 20 in 25 ticks)
    assert sum(ch["step_truncated"].sum() for _j, ch in chunks) == N


def test_rollout_priorities_equal_jax(chunks):
    for jch, ch in chunks:
        got = tpol.rollout_priorities(ch, True)
        ref = jpol.rollout_priorities(
            {k: np.asarray(v) for k, v in jch.items()}, True)
        assert [x is None for x in got.ravel()] == \
            [x is None for x in ref.ravel()]
        ok = np.asarray(ch["prio_ok"], bool)
        np.testing.assert_array_equal(got[ok].astype(np.float64),
                                      ref[ok].astype(np.float64))
    assert tpol.rollout_priorities(chunks[0][1], False) is None


def _rings(capacity, per: bool):
    cls = DevicePerReplay if per else DeviceReplay
    ring = cls(capacity, (2, 3))
    shp = (capacity, 2, 3)
    prov = jnp.full((capacity, 4), -1, jnp.int32)
    z = lambda dt: jnp.zeros((capacity,), dt)
    cols = (jnp.zeros(shp, jnp.uint8), z(jnp.int32), z(jnp.float32),
            z(jnp.float32), jnp.zeros(shp, jnp.uint8), z(jnp.float32), prov)
    if per:
        jring = jper.PerReplayState(*cols, priority=z(jnp.float32),
                                    max_priority=jnp.float32(1.0),
                                    pos=jnp.int32(0), fill=jnp.int32(0))
    else:
        jring = jrep.ReplayState(*cols, pos=jnp.int32(0), fill=jnp.int32(0))
    return ring, jring


@pytest.mark.parametrize("per", [False, True], ids=["uniform", "per"])
def test_masked_writes_equal_jax(per):
    """Mixed masks, an all-invalid write, and a wrap of the 10-row ring."""
    cap, rng = 10, np.random.default_rng(5)
    ring, jring = _rings(cap, per)
    masks = ([1, 0, 1, 1, 0, 1], [0] * 6, [1] * 6, [0, 1, 0, 0, 1, 1],
             [1, 1, 1, 0, 0, 0])
    st = ring.state
    jwrite = jper.per_write_masked if per else jrep.ring_write_masked
    write = per_write_masked if per else ring_write_masked
    for i, m in enumerate(masks):
        valid = np.asarray(m, bool)
        cols = dict(
            state0=rng.integers(0, 255, (6, 2, 3), dtype=np.uint8),
            action=rng.integers(0, 6, 6).astype(np.int32),
            reward=rng.normal(size=6).astype(np.float32),
            gamma_n=rng.random(6).astype(np.float32),
            state1=rng.integers(0, 255, (6, 2, 3), dtype=np.uint8),
            terminal1=(rng.random(6) < 0.3).astype(np.float32))
        if per:  # new rows must take the running max of their write
            st.max_priority.fill_(1.5 + i)
            jring = jring._replace(max_priority=jnp.float32(1.5 + i))
        jring, jn = jwrite(jring, JaxTransition(
            **{k: jnp.asarray(v) for k, v in cols.items()}),
            jnp.asarray(valid), cap)
        st.cursor.fill_(st.pos)
        n = write(st, Transition(**{k: torch.from_numpy(v)
                                    for k, v in cols.items()}),
                  torch.from_numpy(valid), cap)
        st.pos = (st.pos + int(n)) % cap
        st.fill = min(st.fill + int(n), cap)
        assert int(n) == int(jn) == valid.sum()
        assert (st.pos, st.fill) == (int(jring.pos), int(jring.fill))
        assert int(st.cursor) == st.pos
        for f in REPLAY_FIELDS:
            np.testing.assert_array_equal(
                getattr(st, f).numpy(), np.asarray(getattr(jring, f)),
                err_msg=f"write {i} {f}")
        if per:
            np.testing.assert_array_equal(st.priority.numpy(),
                                          np.asarray(jring.priority))
            assert float(st.fill_rows) == st.fill


def test_replay_emit_equals_chunk_emit_through_the_ingest():
    """The same fleet and draws twice: ``emit="replay"`` into one PER ring,
    ``emit="chunk"``'s valid rows through feeder -> queue -> drain into
    another; 4 envs x 5 ticks x 4 dispatches, a 40-row ring, so it wraps."""
    ep = build_options(12, early_stop=9).env_params
    eps = np.full(4, 0.3, np.float32)
    w = torch.from_numpy(_weights(1))
    ingest = DevicePerIngest(capacity=40, state_shape=(4, 84, 84),
                             in_process=True)
    split = ingest.attach("cpu")
    feeder = ingest.make_feeder()
    direct = DevicePerReplay(40, (4, 84, 84))
    kw = dict(nstep=NSTEP, gamma=GAMMA, rollout_ticks=K, eps=eps)
    r_chunk = tpol.build_fused_rollout(_torch_apply,
                                       build_device_env(ep, 0, 4), **kw)
    r_replay = tpol.build_fused_rollout(
        _torch_apply, build_device_env(ep, 0, 4), emit="replay",
        ring=direct.state, ring_write_fn=per_write_masked, **kw)
    c1 = tpol.init_rollout_carry(r_chunk.env, NSTEP)
    c2 = tpol.init_rollout_carry(r_replay.env, NSTEP)
    g1, g2 = (torch.Generator().manual_seed(9) for _ in range(2))
    for d in range(4):
        for ring in (split.state, direct.state):
            ring.max_priority.fill_(1.0 + d)
        r_chunk.draw(g1)
        ch = r_chunk(w, c1)
        for k, j in zip(*np.nonzero(ch.valid.numpy())):
            feeder.feed(Transition(*(getattr(ch, f)[k, j].numpy()
                                     for f in REPLAY_FIELDS)))
        feeder.flush()
        fed = ingest.drain()
        r_replay.draw(g2)
        stats = r_replay(w, c2)
        assert fed == stats.rows == int(stats.fed) == int(ch.valid.sum())
        np.testing.assert_array_equal(stats.step_reward, ch.step_reward)
    a, b = split.state, direct.state
    for f in REPLAY_FIELDS + ("priority", "max_priority", "fill_rows"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (a.pos, a.fill) == (b.pos, b.fill) == ((4 * 17) % 40, 40)


def _row_digest(t) -> str:
    h = hashlib.sha256()
    for f in REPLAY_FIELDS:
        h.update(np.ascontiguousarray(np.asarray(getattr(t, f))).tobytes())
    return h.hexdigest()


def test_device_actor_equals_inline_over_the_wrapper(tmp_path, monkeypatch):
    """16 ticks of 2 envs (early_stop 6: truncations inside): every window
    the device actor emits is one the inline actor emits over
    ``DevicePongVectorEnv``, and the inline actor emits only the last
    ``nstep`` ticks' windows on top (the device rollout emits each window
    ``nstep`` ticks after it opens)."""
    ticks, n, k_roll = 16, 2, 4

    def opt(backend):
        return build_options(
            12, root_dir=str(tmp_path), refs=backend, device="cpu",
            num_actors=1, num_envs_per_actor=n, nstep=NSTEP, early_stop=6,
            actor_backend=backend, device_rollout_ticks=k_roll,
            actor_freq=10 ** 9, actor_sync_freq=10 ** 9)

    monkeypatch.setattr(
        actor_mod, "build_env_vector",
        lambda o, i, m: DevicePongVectorEnv(o.env_params, i, m))
    inline = actor_mod.bounded_actor_run(opt("inline"), ticks)
    device = actor_mod.bounded_actor_run(opt("device"), ticks // k_roll)
    assert device["env_steps"] == inline["env_steps"] == ticks * n
    got = collections.Counter(map(_row_digest, device["stream"]))
    ref = collections.Counter(map(_row_digest, inline["stream"]))
    assert sum(got.values()) == n * (ticks - NSTEP)
    assert not got - ref
    assert 0 < sum((ref - got).values()) <= n * NSTEP
    assert {"rollout", "emit", "advance"} <= {
        k.split("/time_")[1].rsplit("_", 1)[0]
        for k in device["timer_ms"] if "/time_" in k}
