"""The provenance plane of the port against the JAX package, on the CPU:

- ``make_prov``, ``stack_prov`` (``(Transition, priority)`` pairs, bare
  Transitions, rows without provenance, nothing) and
  ``health.provenance_stats``, exactly;
- the same chunks fed to the JAX ``DeviceReplay`` and ``DevicePerReplay``
  and to the port's rings, directly and through the staged drain: equal
  ``prov`` columns, exactly, across a wrap;
- a JAX snapshot with ``prov`` restores it into the port's rings, and
  one without restores -1 rows;
- the host rings (``SharedReplay``, ``PrioritizedReplay``): equal
  ``provenance_of``, snapshots and restores;
- the fused rollout with ``emit="replay"``: the port's and the JAX
  package's write the same ``prov`` rows for the same stamps (the rows'
  provenance depends on the tick window and the stamp alone, not on the
  env's draws), and each dispatch's stamp, not the first one's;
- an inline actor's rows carry ``(actor index, env slot, version,
  birth_step)``, the version switching at the swap."""

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
from pytorch_distributed_tpu.memory.prioritized import (
    PrioritizedReplay as JaxPrioritized,
)
from pytorch_distributed_tpu.memory.shared_replay import (
    SharedReplay as JaxShared,
)
from pytorch_distributed_tpu.models import policies as jpol
from pytorch_distributed_tpu.utils import experience as jexp
from pytorch_distributed_tpu.utils import health as jhealth
from pytorch_distributed_tpu.utils.rngs import process_key
from pytorch_distributed_tpu_torch.agents.actor import bounded_actor_run
from pytorch_distributed_tpu_torch.config import build_options
from pytorch_distributed_tpu_torch.envs.device_env import build_device_env
from pytorch_distributed_tpu_torch.memory.device_per import (
    DevicePerReplay, per_write_masked,
)
from pytorch_distributed_tpu_torch.memory.device_replay import (
    DevicePerIngest, DeviceReplay, provenance_sample,
)
from pytorch_distributed_tpu_torch.memory.prioritized import (
    PrioritizedReplay,
)
from pytorch_distributed_tpu_torch.memory.shared_replay import SharedReplay
from pytorch_distributed_tpu_torch.models import policies as tpol
from pytorch_distributed_tpu_torch.utils import experience as texp
from pytorch_distributed_tpu_torch.utils import health
from pytorch_distributed_tpu_torch.utils.experience import (
    REPLAY_FIELDS, Transition,
)

FRAME = (2, 5, 5)


def _cols(rng, n):
    return dict(
        state0=rng.integers(0, 255, (n, *FRAME)).astype(np.uint8),
        action=rng.integers(0, 6, n).astype(np.int32),
        reward=rng.normal(size=n).astype(np.float32),
        gamma_n=np.full(n, 0.97, np.float32),
        state1=rng.integers(0, 255, (n, *FRAME)).astype(np.uint8),
        terminal1=(rng.random(n) < 0.2).astype(np.float32))


def _provs(rng, n):
    return np.stack([rng.integers(0, 4, n), rng.integers(0, 16, n),
                     rng.integers(0, 50, n), rng.integers(0, 9999, n)],
                    axis=1).astype(np.int64)


def _rows(rng, n, with_prov=True):
    cols, prov = _cols(rng, n), _provs(rng, n)
    out = []
    for i in range(n):
        kw = {f: cols[f][i] for f in cols}
        out.append((kw, prov[i] if with_prov and i % 5 else None))
    return out


def test_make_and_stack_prov_are_the_reference():
    assert np.array_equal(texp.make_prov(3, 7, 11, 123),
                          jexp.make_prov(3, 7, 11, 123))
    assert texp.make_prov(1, 2, 3, 4).dtype == np.int64
    assert texp.PROV_FIELDS == jexp.PROV_FIELDS
    assert np.array_equal(texp.PROV_NONE, jexp.PROV_NONE)
    rows = _rows(np.random.default_rng(0), 12)
    port = [Transition(**kw, prov=p) for kw, p in rows]
    ref = [jexp.Transition(**kw, prov=p) for kw, p in rows]
    want = jexp.stack_prov([(t, 0.5) for t in ref])
    # pairs and bare transitions alike: a Transition is a tuple too
    for items in ([(t, 0.5) for t in port], port, [(t, None) for t in port]):
        got = texp.stack_prov(items)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(jexp.stack_prov(ref), want)
    assert (want[::5] == -1).all() and (want[1::5] >= 0).all()
    assert texp.stack_prov([]).shape == jexp.stack_prov([]).shape == (0, 4)


@pytest.mark.parametrize("case", ["mixed", "unknown"])
def test_provenance_stats_is_the_reference(case):
    prov = _provs(np.random.default_rng(1), 64)
    if case == "unknown":
        prov[:] = -1
    else:
        prov[::3] = -1
    got = health.provenance_stats(prov, 40, 5000)
    want = jhealth.provenance_stats(prov, 40, 5000)
    if case == "unknown":
        assert got is None and want is None
        return
    for k in ("staleness", "age", "shares"):
        assert np.array_equal(got[k], want[k]), k
    assert abs(got["shares"].sum() - 1.0) < 1e-12


def _feed_both(per: bool, sizes, with_prov=True):
    rng = np.random.default_rng(2)
    cap = 20
    jring = (jper.DevicePerReplay if per else jrep.DeviceReplay)(cap, FRAME)
    ring = (DevicePerReplay if per else DeviceReplay)(cap, FRAME)
    for n in sizes:
        cols, prov = _cols(rng, n), _provs(rng, n)
        jprov = jnp.asarray(prov.astype(np.int32)) if with_prov else None
        jring.feed_chunk(jexp.Transition(
            **{k: jnp.asarray(v) for k, v in cols.items()}, prov=jprov))
        ring.feed_chunk(Transition(**cols,
                                   prov=prov if with_prov else None))
    return jring, ring


@pytest.mark.parametrize("per", [False, True], ids=["uniform", "per"])
def test_device_ring_prov_column_equals_jax(per):
    jring, ring = _feed_both(per, (7, 9, 11))  # wraps the 20-row ring
    got = ring.state.prov.numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, np.asarray(jring.state.prov))
    # a chunk without provenance overwrites with -1, as the JAX ring does
    rng = np.random.default_rng(3)
    cols = _cols(rng, 4)
    jring.feed_chunk(jexp.Transition(
        **{k: jnp.asarray(v) for k, v in cols.items()}))
    ring.feed_chunk(Transition(**cols))
    assert np.array_equal(ring.state.prov.numpy(),
                          np.asarray(jring.state.prov))
    snap, jsnap = ring.snapshot(), jring.snapshot()
    assert snap["prov"].dtype == jsnap["prov"].dtype == np.int64
    assert np.array_equal(snap["prov"], jsnap["prov"])


def test_staged_drain_carries_prov():
    """Rows through feeder -> queue -> drain (the pinned-slab path) land
    with the prov the JAX ring's direct feed gives them."""
    rng = np.random.default_rng(4)
    rows = _rows(rng, 30)
    ingest = DevicePerIngest(40, FRAME, in_process=True)
    ingest.attach("cpu")
    feeder = ingest.make_feeder(chunk=7)
    for kw, p in rows:
        feeder.feed(Transition(**kw, prov=p))
    feeder.flush()
    assert ingest.drain() == 30
    jring = jper.DevicePerReplay(40, FRAME)
    jring.feed_chunk(jexp.Transition(
        **{f: jnp.asarray(np.stack([kw[f] for kw, _p in rows]))
           for f in REPLAY_FIELDS},
        prov=jnp.asarray(jexp.stack_prov(
            [jexp.Transition(**kw, prov=p) for kw, p in rows]
        ).astype(np.int32))))
    assert np.array_equal(ingest.replay.state.prov.numpy(),
                          np.asarray(jring.state.prov))


@pytest.mark.parametrize("with_prov", [True, False],
                         ids=["snapshot_with_prov", "pre_prov_snapshot"])
@pytest.mark.parametrize("per", [False, True], ids=["uniform", "per"])
def test_jax_snapshot_restores_prov(per, with_prov):
    jring, _ = _feed_both(per, (13, 12))
    snap = dict(jring.snapshot())
    if not with_prov:
        snap.pop("prov")
    ring = (DevicePerReplay if per else DeviceReplay)(20, FRAME)
    ring.feed_chunk(Transition(**_cols(np.random.default_rng(9), 3),
                               prov=np.zeros((3, 4), np.int64)))
    assert ring.restore(snap) == 20
    got = ring.snapshot()["prov"]
    if with_prov:
        assert np.array_equal(got, jring.snapshot()["prov"])
    else:
        # the stamps written before the restore are gone too
        assert (ring.state.prov.numpy() == -1).all()


def test_provenance_sample_draws_valid_rows():
    _jring, ring = _feed_both(True, (9,))
    prov, fill = provenance_sample(ring.state, np.random.default_rng(0), 256)
    assert fill == 9 and prov.shape == (256, 4) and prov.dtype == np.int64
    rows = {tuple(r) for r in ring.state.prov.numpy()[:9].astype(np.int64)}
    assert {tuple(r) for r in prov} <= rows


@pytest.mark.parametrize("kind", ["shared", "prioritized"])
def test_host_ring_provenance_of_is_the_reference(kind):
    cap = 16
    port = (SharedReplay if kind == "shared" else PrioritizedReplay)(
        cap, FRAME)
    ref = (JaxShared if kind == "shared" else JaxPrioritized)(cap, FRAME)
    for kw, p in _rows(np.random.default_rng(5), 21):  # wraps
        port.feed(Transition(**kw, prov=p))
        ref.feed(jexp.Transition(**kw, prov=p))
    idx = np.array([0, 3, 5, 7, 15, 2, 3])
    got, want = port.provenance_of(idx), ref.provenance_of(idx)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    snap, jsnap = port.snapshot(), ref.snapshot()
    assert np.array_equal(snap["prov"], jsnap["prov"])
    back = (SharedReplay if kind == "shared" else PrioritizedReplay)(
        cap, FRAME)
    ref_back = (JaxShared if kind == "shared" else JaxPrioritized)(cap, FRAME)
    for ring in (back, ref_back):
        ring.restore(jsnap)
    assert np.array_equal(back.provenance_of(np.arange(cap)),
                          ref_back.provenance_of(np.arange(cap)))
    jsnap.pop("prov")
    back.restore(jsnap)
    assert (back.provenance_of(np.arange(cap)) == -1).all()


N, NSTEP, K = 3, 3, 5


def _apply_jax(p, obs):
    return jnp.zeros((obs.shape[0], 6), jnp.float32) + p


def _apply_torch(p, obs):
    return torch.zeros((obs.shape[0], 6)) + p


@pytest.mark.parametrize("per", [False, True], ids=["uniform", "per"])
def test_fused_rollout_writes_the_jax_prov_rows(per):
    """Three dispatches into a 16-row ring (it wraps), each with its own
    stamp, then one without: the ``prov`` column equals the JAX ring's."""
    ep = build_options(12, early_stop=20).env_params
    jep = jax_options(4).env_params
    jep.early_stop = 20
    eps = np.full(N, 0.5, np.float32)
    cap = 16
    jring = (jper.DevicePerReplay if per else jrep.DeviceReplay)(cap, (4, 84, 84))
    jstate = jring.state
    jenv = jax_device_env(jep, 0, N)
    jroll = jpol.build_fused_rollout(
        _apply_jax, jenv, nstep=NSTEP, gamma=0.99, rollout_ticks=K,
        emit="replay",
        ring_write_fn=jper.per_write_masked if per else None)
    jcarry = jpol.init_rollout_carry(jenv, NSTEP)
    ring = (DevicePerReplay if per else DeviceReplay)(cap, (4, 84, 84))
    roll = tpol.build_fused_rollout(
        _apply_torch, build_device_env(ep, 0, N), nstep=NSTEP, gamma=0.99,
        rollout_ticks=K, eps=eps, emit="replay", ring=ring.state,
        ring_write_fn=per_write_masked if per else None)
    carry = tpol.init_rollout_carry(roll.env, NSTEP)
    gen = torch.Generator().manual_seed(0)
    key = process_key(100, "actor", 0)
    stamps = [(0, 1, 10), (0, 2, 25), (0, 2, 40), None]
    for d, stamp in enumerate(stamps):
        jprov = None if stamp is None else jnp.asarray(stamp, jnp.int32)
        jcarry, jstate, _stats = jroll(jnp.float32(0.0), jcarry, jstate,
                                       key, jnp.int32(d * K),
                                       jnp.asarray(eps), jprov)
        roll.draw(gen)
        roll(torch.tensor(0.0), carry, prov=stamp)
        np.testing.assert_array_equal(ring.state.prov.numpy(),
                                      np.asarray(jstate.prov),
                                      err_msg=f"dispatch {d}")
    assert (ring.state.pos, ring.state.fill) == (int(jstate.pos),
                                                 int(jstate.fill))
    got = ring.state.prov.numpy()
    assert set(got[:, 2]) >= {2, -1}  # the later stamps, not the first


def test_inline_actor_rows_carry_their_provenance():
    opt = build_options(12, device="cpu", num_actors=2,
                        num_envs_per_actor=3, actor_backend="inline",
                        native_env=False, actor_freq=10 ** 9,
                        actor_sync_freq=3, nstep=2)
    out = bounded_actor_run(opt, ticks=40, process_ind=1, publish_at=20)
    prov = texp.stack_prov(out["stream"])
    assert len(prov) > 60 and (prov >= 0).all()
    assert set(prov[:, 0]) == {1}
    assert set(prov[:, 1]) == {0, 1, 2}
    assert (prov[:, 3] == 0).all()  # the bounded clock's learner step
    versions = prov[:, 2]
    assert set(versions) == {1, 2} and out["version"] == 2
    # rows are emitted in tick order: the version switches once
    first_new = np.argmax(versions == 2)
    assert (versions[:first_new] == 1).all()
    assert (versions[first_new:] == 2).all()
