"""The port's device Pong (pytorch_distributed_tpu_torch/envs/device_env.py)
against the JAX package's (pytorch_distributed_tpu/envs/device_env.py).

- The counter hash and its uniforms: equal to the JAX package's to the
  bit, at seeds and counts of 2**31 and more and across the uint32 wrap.
- The torch step in float32 on the CPU: equal to the bit, every StepOut
  field and every state field, to the port's numpy float32 oracle and to
  the JAX package's numpy oracle (``xp=numpy``) over full truncated
  episodes (obs, rewards, terminals, truncation and ``final_obs``
  through auto-resets).  Against the JAX package's jitted step the same
  holds for every StepOut field over the horizon the JAX package's own
  test holds (4 envs, 80 steps, early_stop 30): XLA on the CPU rewrites
  ``x / 5.0`` as ``x * 0.2``, so its ball velocity leaves the oracle by
  an ulp after the first paddle hit and its frames later on; the port
  keeps the division, the oracle's and the host ``PongSimEnv``'s.
- The float64 numpy oracle against the port's ``PongSimEnv`` with the
  counter stream patched in (``CounterRng``): equal over full episodes.
- The slot-seed contract ``seed + i*N + j`` and ``DevicePongVectorEnv``'s
  vector-env contract.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_distributed_tpu.config import build_options as jax_options
from pytorch_distributed_tpu.envs import device_env as jde
from pytorch_distributed_tpu_torch.config import build_options
from pytorch_distributed_tpu_torch.envs import device_env as tde
from pytorch_distributed_tpu_torch.envs.pong_sim import PongSimEnv


def _params(early_stop):
    ep = build_options(12).env_params
    ep.early_stop = early_stop
    jep = jax_options(4).env_params
    jep.early_stop = early_stop
    return ep, jep


def _hash_inputs():
    rng = np.random.default_rng(7)
    seeds = rng.integers(0, 2 ** 32, size=4000, dtype=np.uint64)
    counts = rng.integers(2 ** 31, 2 ** 32, size=4000, dtype=np.uint64)
    # the uint32 wrap: counts at the top of the range, seeds at both ends
    counts[:4] = [2 ** 32 - 1, 2 ** 32 - 2, 2 ** 31, 2 ** 31 - 1]
    seeds[:4] = [0, 2 ** 32 - 1, 2 ** 31, 100]
    return seeds.astype(np.uint32), counts.astype(np.uint32)


def test_counter_mix_equals_jax_to_the_bit():
    seeds, counts = _hash_inputs()
    ref = jde.counter_mix(seeds, counts).astype(np.int64)
    s64, c64 = seeds.astype(np.int64), counts.astype(np.int64)
    np.testing.assert_array_equal(tde.counter_mix(s64, c64), ref)
    np.testing.assert_array_equal(
        tde.counter_mix(torch.from_numpy(s64), torch.from_numpy(c64)).numpy(),
        ref)
    # a count past 2**32 wraps as uint32 does (count + 1 at the top)
    np.testing.assert_array_equal(
        tde.counter_mix(s64[:1], np.int64(2 ** 32)),
        jde.counter_mix(seeds[:1], np.uint32(0)).astype(np.int64))


@pytest.mark.parametrize("lo,hi", [(20.0, 64.0), (-1.2, 1.2), (0.0, 1.0)])
def test_counter_uniform_equals_jax_to_the_bit(lo, hi):
    seeds, counts = _hash_inputs()
    s64, c64 = seeds.astype(np.int64), counts.astype(np.int64)
    for dt in (np.float32, np.float64):
        ref = jde.counter_uniform(seeds, counts, lo, hi, xp=np, dtype=dt)
        got = tde.counter_uniform(s64, c64, lo, hi, tde.NumpyOps(dt))
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    ref32 = jde.counter_uniform(seeds, counts, lo, hi, xp=np,
                                dtype=np.float32)
    got = tde.counter_uniform(torch.from_numpy(s64), torch.from_numpy(c64),
                              lo, hi, tde.TorchOps())
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref32)


def test_counter_rng_replays_the_jax_stream():
    a, b = tde.CounterRng(2 ** 31 + 5), jde.CounterRng(2 ** 31 + 5)
    for _ in range(50):
        assert a.uniform(-1.2, 1.2) == b.uniform(-1.2, 1.2)
        assert a.random() == b.random()


def _fields_equal(a, b, where):
    for name in a._fields:
        x = np.asarray(getattr(a, name))
        y = getattr(b, name)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert np.array_equal(x.astype(y.dtype) if x.dtype != y.dtype
                              else x, y), (where, name)


def test_torch_step_equals_both_numpy_oracles_full_episodes():
    """Three full truncated episodes (early_stop 40) and the start of a
    fourth, every state and StepOut field, through auto-resets."""
    ep, jep = _params(40)
    slots = [ep.seed + j for j in range(3)]
    dev = tde.make_device_pong(ep, slots)
    orc = tde.make_device_pong(ep, slots, ops=tde.NumpyOps(np.float32))
    jorc = jde.make_device_pong(jep, slots, xp=np, dtype=np.float32)
    sd, so, sj = dev.init(), orc.init(), jorc.init()
    _fields_equal(sj, sd, "init")
    _fields_equal(so, sd, "init")
    rng = np.random.default_rng(1)
    terminals = truncs = 0
    for t in range(130):
        acts = rng.integers(0, 6, size=3)
        sd, od = dev.step(sd, torch.as_tensor(acts))
        so, oo = orc.step(so, acts)
        sj, oj = jorc.step(sj, acts.astype(np.int32))
        for ref in (oo, oj):
            _fields_equal(ref, od, t)
        for ref in (so, sj):
            _fields_equal(ref, sd, t)
        terminals += int(od.terminal.sum())
        truncs += int(od.truncated.sum())
    assert truncs == terminals == 9  # 3 envs x 3 episodes, all truncated
    assert int(sd.rng_count.max()) > 3  # points scored: serves redrawn


def test_torch_step_equals_jitted_jax_over_its_horizon():
    ep, jep = _params(30)
    slots = [ep.seed + j for j in range(4)]
    dev = tde.make_device_pong(ep, slots)
    jenv = jde.build_device_env(jep, 0, 4)
    jstep = jax.jit(jenv.step)
    sd, sj = dev.init(), jenv.init()
    _fields_equal(sj, sd, "init")
    rng = np.random.default_rng(1)
    for t in range(80):
        acts = rng.integers(0, 6, size=4)
        sd, od = dev.step(sd, torch.as_tensor(acts))
        sj, oj = jstep(sj, jnp.asarray(acts, jnp.int32))
        _fields_equal(oj, od, t)


def test_f64_oracle_matches_the_ports_pongsim_full_episodes():
    """The port's float64 oracle against the port's host ``PongSimEnv``
    whose generator is the counter stream (installed after ``__init__``,
    whose throwaway draws are not part of it), so the first ``reset``
    draws counters 1..3 as ``init`` does."""
    ep, _ = _params(40)
    slots = [ep.seed + j for j in range(3)]
    orc = tde.make_device_pong(ep, slots, ops=tde.NumpyOps(np.float64))
    hosts = []
    for s in slots:
        e = PongSimEnv(ep, process_ind=s - ep.seed)
        e.rng = tde.CounterRng(s)
        hosts.append(e)
    st = orc.init()
    np.testing.assert_array_equal(st.stack,
                                  np.stack([e.reset() for e in hosts]))
    rng = np.random.default_rng(0)
    resets = 0
    for _t in range(100):
        acts = rng.integers(0, 6, size=3)
        st, out = orc.step(st, acts)
        for j, e in enumerate(hosts):
            o, r, term, info = e.step(int(acts[j]))
            assert float(out.reward[j]) == r
            assert bool(out.terminal[j]) == bool(term)
            assert bool(out.truncated[j]) == bool(info.get("truncated",
                                                           False))
            np.testing.assert_array_equal(out.final_obs[j], o)
            if term:
                resets += 1
                o = e.reset()
            np.testing.assert_array_equal(out.obs[j], o)
    assert resets == 6


def test_slot_seeds_follow_the_fleet_contract():
    ep, jep = _params(0)
    for i, n in ((0, 3), (2, 3), (1, 5)):
        env = tde.build_device_env(ep, i, n)
        st = env.init()
        assert st.seed.tolist() == [ep.seed + i * n + j for j in range(n)]
        jst = jde.build_device_env(jep, i, n).init()
        np.testing.assert_array_equal(np.asarray(jst.stack), st.stack.numpy())
    # env j of actor i is the same game whatever the split
    whole = tde.build_device_env(ep, 0, 6).init().stack
    part = tde.build_device_env(ep, 1, 3).init().stack
    assert torch.equal(whole[3:], part)


def test_family_gate():
    ep, _ = _params(0)
    assert tde.resolve_device_env_family(ep) == "pong"
    assert tde.device_env_supported(ep)
    ep.device_env_family = "pong"
    assert tde.resolve_device_env_family(ep) == "pong"
    ep.device_env_family = "cartpole"
    with pytest.raises(ValueError, match="does not implement"):
        tde.resolve_device_env_family(ep)
    ep.device_env_family = "auto"
    ep.env_type = "fake"
    assert not tde.device_env_supported(ep)
    with pytest.raises(ValueError, match="no device env"):
        tde.build_device_env(ep, 0, 2)


def test_vector_wrapper_contract_against_the_oracle():
    """``DevicePongVectorEnv``: reset/step shapes and dtypes, auto-reset
    with ``final_obs`` and ``truncated`` in the infos, every array equal
    to the numpy oracle's."""
    ep, _ = _params(20)
    vec = tde.DevicePongVectorEnv(ep, 1, 3)
    orc = tde.build_device_env(ep, 1, 3, ops=tde.NumpyOps(np.float32))
    assert vec.state_shape == (4, 84, 84) and vec.action_space.n == 6
    obs = vec.reset()
    so = orc.init()
    assert obs.dtype == np.uint8 and obs.shape == (3, 4, 84, 84)
    np.testing.assert_array_equal(obs, so.stack)
    rng = np.random.default_rng(3)
    ends = 0
    for _t in range(45):
        acts = rng.integers(0, 6, size=3)
        obs, rew, term, infos = vec.step(acts)
        so, oo = orc.step(so, acts)
        np.testing.assert_array_equal(obs, oo.obs)
        np.testing.assert_array_equal(rew, oo.reward)
        np.testing.assert_array_equal(term, oo.terminal)
        assert rew.dtype == np.float32 and term.dtype == bool
        for j, info in enumerate(infos):
            assert info["score"] == tuple(int(v) for v in oo.score[j])
            if term[j]:
                ends += 1
                np.testing.assert_array_equal(info["final_obs"],
                                              oo.final_obs[j])
                assert info["truncated"] is True
            else:
                assert "final_obs" not in info
    assert ends == 6
    with pytest.raises(ValueError, match="actions of shape"):
        vec.step([0, 1])
