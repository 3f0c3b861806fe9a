"""The R2D2 actor (agents/recurrent_actor.py), the recurrent acts of
models/policies.py and the ``Segment`` branch of the health plane:

- the packed act with a per-row reset mask and the greedy act against the
  JAX package's on converted weights: greedy actions equal, carries
  within rtol 1e-5 (the reset rows acting from the zero carry); rows
  whose uniform is below their epsilon take their random action;
- row 13's actor over 80 ticks of 3 chain envs (``early_stop`` 10, so
  episodes end by death and by truncation): ``inline`` and ``pipelined``
  feed the same segments, to the bit; each env's first segment and every
  segment after an episode's end store the zero carry; every other
  segment stores the carry that the model's steps over the previous
  segment's first ``seq_len - seq_overlap`` observations give (within
  rtol 1e-5), so the carry stored with a step is the one before acting
  and the host copy agrees with the device carry at every boundary; a
  truncated segment has no terminal;
- ``batched`` steps down to ``pipelined`` with the reference's warning;
- ``ChunkValidator`` on segments (clean, non-finite reward, mask, carry
  and obs, a drifted obs shape and dtype, an action out of range, a bad
  priority) against the JAX package's verdicts, exactly; the quarantine
  file of rejected segments holds the JAX package's columns, exactly."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pytorch_distributed_tpu.memory import sequence_replay as jsr
from pytorch_distributed_tpu.models import policies as jpol
from pytorch_distributed_tpu.models.drqn import DrqnMlpModel as JaxMlp
from pytorch_distributed_tpu.utils import flight_recorder as jax_fr
from pytorch_distributed_tpu.utils import health as jax_health
from pytorch_distributed_tpu_torch.agents.actor import bounded_actor_run
from pytorch_distributed_tpu_torch.config import build_options
from pytorch_distributed_tpu_torch.convert import convert_drqn
from pytorch_distributed_tpu_torch.factory import (
    build_model, init_params, probe_env, resolve_actor_backend,
)
from pytorch_distributed_tpu_torch.memory.sequence_replay import Segment
from pytorch_distributed_tpu_torch.models.drqn import DrqnMlpModel
from pytorch_distributed_tpu_torch.models.policies import (
    recurrent_greedy_act, recurrent_packed_act,
)
from pytorch_distributed_tpu_torch.utils import flight_recorder, health

OBS, A, LSTM = 5, 3, 8
F32 = dict(rtol=1e-5, atol=1e-6)


def test_recurrent_acts_match_jax():
    jm = JaxMlp(action_space=A, hidden_dim=16, lstm_dim=LSTM)
    jp = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS)))
    tm = DrqnMlpModel(A, OBS, 16, LSTM, init_weights=False)
    p = convert_drqn(jp)
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(4, OBS)).astype(np.float32)
    c, h = (rng.normal(size=(4, LSTM)).astype(np.float32) for _ in "ch")
    mask = np.array([True, False, True, False])
    jact = jpol.build_recurrent_packed_act(jm.apply, jm.zero_carry(1))
    a_j, (c_j, h_j) = jact(jp, obs, (jnp.array(c), jnp.array(h)), mask,
                           jax.random.PRNGKey(1), 0,
                           jnp.zeros(4, jnp.float32))
    t = torch.from_numpy
    zeros, ones = torch.zeros(4), torch.ones(4)
    ra = torch.tensor([2, 0, 1, 2])
    a_t, (c_t, h_t) = recurrent_packed_act(
        tm.step, p, t(obs), (t(c), t(h)), t(mask), zeros, ones, ra)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), **F32)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), **F32)
    # the reset rows acted from zeros: the greedy act from the zero carry
    g_j, (_c0, h0_j) = jpol.build_recurrent_greedy_act(jm.apply)(
        jp, obs, jm.zero_carry(4))
    g_t, (_c0t, h0_t) = recurrent_greedy_act(tm.step, p, t(obs),
                                             tm.zero_carry(4))
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    np.testing.assert_allclose(h0_t.numpy(), np.asarray(h0_j), **F32)
    np.testing.assert_allclose(h_t.numpy()[mask], np.asarray(h0_j)[mask],
                               **F32)
    # explore: every row whose uniform is below its epsilon
    a_x, _ = recurrent_packed_act(tm.step, p, t(obs), (t(c), t(h)),
                                  t(mask), ones, zeros, ra)
    assert torch.equal(a_x, ra)


def _opt(backend: str, **kw):
    return build_options(
        13, device="cpu", num_actors=1, num_envs_per_actor=3, seq_len=6,
        seq_overlap=3, burn_in=2, actor_freq=10 ** 9, early_stop=10,
        hidden_dim=16, lstm_dim=LSTM, actor_backend=backend, **kw)


def _same_segments(a, b) -> None:
    assert len(a) == len(b)
    for s, t in zip(a, b):
        for f in Segment._fields:
            np.testing.assert_array_equal(getattr(s, f), getattr(t, f))


def test_inline_and_pipelined_feed_the_same_segments():
    runs = {b: bounded_actor_run(_opt(b), 80)["stream"]
            for b in ("inline", "pipelined")}
    assert len(runs["inline"]) > 20
    _same_segments(runs["inline"], runs["pipelined"])


def test_stored_carries_are_the_carries_before_acting():
    opt = _opt("pipelined")
    segs = bounded_actor_run(opt, 80)["stream"]
    spec = probe_env(opt)
    model = build_model(opt, spec)
    params = init_params(opt, spec, seed=0)  # the bounded run's snapshot
    stride = opt.agent_params.seq_len - opt.agent_params.seq_overlap
    by_env = {}
    for s in segs:
        by_env.setdefault(int(s.prov[1]), []).append(s)
    assert sorted(by_env) == [0, 1, 2]
    continued = starts = truncated = 0
    for stream in by_env.values():
        assert not stream[0].c0.any() and not stream[0].h0.any()
        for prev, seg in zip(stream, stream[1:]):
            if not seg.c0.any() and not seg.h0.any():
                starts += 1  # a new episode
                continue
            continued += 1
            carry = (torch.from_numpy(prev.c0[None]),
                     torch.from_numpy(prev.h0[None]))
            with torch.no_grad():
                for k in range(stride):
                    _q, carry = model.step(
                        params, torch.from_numpy(prev.obs[k][None]), carry)
            np.testing.assert_allclose(seg.c0, carry[0][0].numpy(), **F32)
            np.testing.assert_allclose(seg.h0, carry[1][0].numpy(), **F32)
        truncated += sum(1 for s in stream
                         if s.mask.sum() < 6 and not s.terminal.any())
    assert continued > 5 and starts > 2 and truncated > 0


def test_batched_steps_down_to_pipelined():
    with pytest.warns(UserWarning, match="does not serve agent_type=r2d2"):
        assert resolve_actor_backend(_opt("batched"), inference=object()) \
            == "pipelined"
    for backend in ("device", "anakin"):
        with pytest.warns(UserWarning):
            assert resolve_actor_backend(_opt(backend)) == "pipelined"


def _segments(cls):
    rng = np.random.default_rng(3)

    def seg(**kw):
        base = dict(obs=rng.normal(size=(7, 5)).astype(np.float32),
                    action=rng.integers(0, 2, 6).astype(np.int32),
                    reward=rng.normal(size=6).astype(np.float32),
                    terminal=np.zeros(6, np.float32),
                    mask=np.ones(6, np.float32),
                    c0=np.zeros(4, np.float32), h0=np.zeros(4, np.float32))
        base.update(kw)
        return cls(**base)

    nan6 = np.full(6, np.nan, np.float32)
    return [(seg(), None), (seg(reward=nan6), None), (seg(mask=nan6), None),
            (seg(c0=np.full(4, np.nan, np.float32)), None),
            (seg(obs=np.full((7, 5), np.nan, np.float32)), None),
            (seg(obs=np.zeros((8, 5), np.float32)), None),
            (seg(obs=np.zeros((7, 5), np.float64)), None),
            (seg(action=np.full(6, 5, np.int32)), None),
            (seg(), float("nan")), (seg(), 0.5)]


def test_segment_verdicts_match_jax():
    mine = health.ChunkValidator(state_shape=(5,), state_dtype=np.float32,
                                 num_actions=2)
    ref = jax_health.ChunkValidator(state_shape=(5,),
                                    state_dtype=np.float32, num_actions=2)
    rows, jrows = _segments(Segment), _segments(jsr.Segment)
    got = [mine._check(t, p) for t, p in rows]
    want = [ref._check(t, p) for t, p in jrows]
    assert got == want
    assert got[0] is None and got[-1] is None
    assert sum(r is not None for r in got) == 8


def test_segment_quarantine_files_match_jax(tmp_path):
    got = {}
    for name, mod, fr, cls in (("jax", jax_health, jax_fr, jsr.Segment),
                               ("port", health, flight_recorder, Segment)):
        fr.configure(str(tmp_path / name), run_id="run-q")
        v = mod.ChunkValidator(state_shape=(5,), state_dtype=np.float32,
                               num_actions=2)
        bad = v.filter([it for it in _segments(cls)
                        if it[0].obs.shape == (7, 5)])[1]
        path = mod.QuarantineStore("feeder-local").put(bad, trace_id=0)
        with np.load(path) as z:
            got[name] = {k: z[k] for k in z.files}
    assert got["port"].keys() == got["jax"].keys()
    assert "obs" in got["port"] and "c0" in got["port"]
    for k in got["jax"]:
        if k != "wall":
            np.testing.assert_array_equal(got["port"][k], got["jax"][k],
                                          err_msg=k)
    flight_recorder.reset()
    jax_fr.reset()


# ---------------------------------------------------------------------------
# Row 15: the DTQN actor (a (window, filled) carry, placeholder segments)
# ---------------------------------------------------------------------------

def _dtqn_opt(backend: str):
    return build_options(
        15, device="cpu", num_actors=1, num_envs_per_actor=3, seq_len=6,
        seq_overlap=3, actor_freq=10 ** 9, early_stop=10, tf_dim=32,
        actor_backend=backend)


def test_dtqn_inline_and_pipelined_feed_the_same_segments():
    runs = {b: bounded_actor_run(_dtqn_opt(b), 80)["stream"]
            for b in ("inline", "pipelined")}
    assert len(runs["inline"]) > 20
    _same_segments(runs["inline"], runs["pipelined"])
    for seg in runs["inline"]:  # the stored state is the placeholder
        assert seg.c0.shape == seg.h0.shape == (1,)
        assert not seg.c0.any() and not seg.h0.any()


def test_dtqn_acting_stream_matches_the_jax_actor():
    """The packed act over 12 ticks of 3 rows with epsilons 0.5, 0.2 and
    0.8 and per-row resets, on converted weights: the port is handed the
    uniforms and random actions the JAX actor draws from its row keys
    (``tick_keys``), and acts the same, with the same (window, filled)
    carry to the bit."""
    from pytorch_distributed_tpu.models.dtqn import DtqnMlpModel as JaxDtqn
    from pytorch_distributed_tpu_torch.convert import convert_dtqn

    B, W = 3, 7
    jm = JaxDtqn(action_space=2, state_shape=(8,), window=W + 1, dim=32,
                 heads=4, depth=2)
    jp = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8)))
    rng = np.random.default_rng(1)
    jp = jax.tree_util.tree_map(lambda x: np.asarray(x) + 0.3 * rng.normal(
        size=x.shape).astype(np.float32), jp)
    opt = build_options(15, device="cpu", seq_len=W, tf_dim=32)
    model = build_model(opt, probe_env(opt), init_weights=False)
    p = convert_dtqn(jp)
    eps = np.array([0.5, 0.2, 0.8], np.float32)
    base = jax.random.PRNGKey(9)
    jact = jpol.build_recurrent_packed_act(jm.apply, jm.zero_carry(1))
    jcarry, carry = jm.zero_carry(B), model.zero_carry(B)
    explored = 0
    for tick in range(12):
        obs = (rng.random((B, 8)) < 0.3).astype(np.float32)
        reset = np.zeros(B, bool)
        if tick in (4, 9):
            reset[tick % B] = True
        a_j, jcarry = jact(jp, obs, jcarry, reset, base, tick, eps)
        # the JAX actor's draws for this tick, row by row
        u, ra = [], []
        for key in jpol.tick_keys(base, tick, B):
            k_explore, k_choice = jax.random.split(key)
            ra.append(int(jax.random.randint(k_choice, (), 0, 2)))
            u.append(float(jax.random.uniform(k_explore)))
        a_t, carry = recurrent_packed_act(
            model.step, p, torch.from_numpy(obs), carry,
            torch.from_numpy(reset), torch.from_numpy(eps), torch.tensor(u),
            torch.tensor(ra))
        np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
        for want, got in zip(jcarry, carry):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        explored += int((np.array(u) < eps).sum())
    assert 0 < explored < 12 * B
