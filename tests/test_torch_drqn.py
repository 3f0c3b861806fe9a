"""The port's recurrent Q-networks (models/drqn.py) and the sequence ops of
ops/sequence_losses.py against the JAX package's, on the same weights
(carried across by ``convert.convert_drqn``) and the same numpy inputs:

- ``DrqnMlpModel`` one step from a given carry against flax (fp32: rtol
  1e-5, atol 1e-6), and from the zero carry;
- ``DrqnCnnModel`` at 84 x 84 frames (a bf16 torso: rtol and atol 2e-2 on
  Q, 1e-2 on the carry);
- the published vector of both models in the reference's
  ``ravel_pytree`` layout, exactly;
- the torso-batched ``sequence`` against the step-wise unroll (the port's
  ``unroll`` over ``step``, rtol 1e-5) and against the reference's
  ``unroll`` (rtol 1e-5);
- the port's own init: flax's LeCun-normal spread and orthogonal
  recurrent kernels;
- ``value_rescale`` (rtol 1e-6) and ``value_unrescale`` (rtol 1e-4: it
  amplifies fp32 rounding 500-fold) and their round trip, ``unpack_frame_stacks`` (exact), and ``nstep_window_returns``
  on random rewards, terminals and masks (rtol 1e-6), with the
  reference's terminal and truncation cases."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.flatten_util import ravel_pytree

from pytorch_distributed_tpu.models.drqn import (
    DrqnCnnModel as JaxCnn, DrqnMlpModel as JaxMlp,
)
from pytorch_distributed_tpu.ops import sequence_losses as jsl
from pytorch_distributed_tpu_torch.agents.param_store import (
    flatten_into, make_flattener, num_params,
)
from pytorch_distributed_tpu_torch.convert import convert_drqn
from pytorch_distributed_tpu_torch.models.drqn import (
    DrqnCnnModel, DrqnMlpModel,
)
from pytorch_distributed_tpu_torch.ops import sequence_losses as sl

OBS, A, HID, LSTM = 5, 3, 16, 8
FRAME, CNN_LSTM = (4, 84, 84), 32
F32 = dict(rtol=1e-5, atol=1e-6)


def _mlp(seed: int = 0):
    jm = JaxMlp(action_space=A, hidden_dim=HID, lstm_dim=LSTM)
    jp = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, OBS)))
    tm = DrqnMlpModel(A, OBS, hidden_dim=HID, lstm_dim=LSTM,
                      init_weights=False)
    return jm, jp, tm, convert_drqn(jp)


def _cnn(seed: int = 1):
    jm = JaxCnn(action_space=6, lstm_dim=CNN_LSTM)
    jp = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, *FRAME), jnp.uint8))
    tm = DrqnCnnModel(6, FRAME, lstm_dim=CNN_LSTM, init_weights=False)
    return jm, jp, tm, convert_drqn(jp, FRAME)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_mlp_step_matches_flax():
    jm, jp, tm, p = _mlp()
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(4, OBS)).astype(np.float32)
    c, h = (rng.normal(size=(4, LSTM)).astype(np.float32) for _ in "ch")
    qj, (cj, hj) = jm.apply(jp, obs, (c, h))
    qt, (ct, ht) = tm.step(p, _t(obs), (_t(c), _t(h)))
    for a, b in ((qj, qt), (cj, ct), (hj, ht)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **F32)
    # no carry: the zero carry, as the reference's default
    q0j, _ = jm.apply(jp, obs)
    q0t, _ = tm.step(p, _t(obs))
    np.testing.assert_allclose(q0t.numpy(), np.asarray(q0j), **F32)
    # the converted dict loads into the module as its state dict
    tm.load_state_dict(p)


def test_cnn_step_matches_flax_in_bf16():
    jm, jp, tm, p = _cnn()
    rng = np.random.default_rng(1)
    obs = rng.integers(0, 255, (2, *FRAME)).astype(np.uint8)
    c, h = (0.5 * rng.normal(size=(2, CNN_LSTM)).astype(np.float32)
            for _ in "ch")
    qj, (cj, hj) = jm.apply(jp, obs, (c, h))
    qt, (ct, ht) = tm.step(p, _t(obs), (_t(c), _t(h)))
    assert qt.dtype == ct.dtype == torch.float32
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=2e-2,
                               atol=2e-2)
    for a, b in ((cj, ct), (hj, ht)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-2,
                                   atol=1e-2)


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_published_vector_is_ravel_pytree(kind):
    _jm, jp, tm, p = _mlp() if kind == "mlp" else _cnn()
    shape = (OBS,) if kind == "mlp" else FRAME
    flat = flatten_into(p, torch.empty(num_params(p)), shape).numpy()
    np.testing.assert_array_equal(flat, np.asarray(ravel_pytree(jp)[0]))
    # and the inverse: the vector back into a state dict of the model's
    _flat0, unflatten = make_flattener(tm.state_dict(), shape)
    back = unflatten(flat)
    for k, v in p.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy())


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_sequence_matches_stepwise_unroll(kind):
    jm, jp, tm, p = _mlp() if kind == "mlp" else _cnn()
    rng = np.random.default_rng(2)
    T, B = 5, 2
    if kind == "mlp":
        obs = rng.normal(size=(T, B, OBS)).astype(np.float32)
        width = LSTM
    else:
        obs = rng.integers(0, 255, (T, B, *FRAME)).astype(np.uint8)
        width = CNN_LSTM
    c0 = tuple(_t(0.3 * rng.normal(size=(B, width)).astype(np.float32))
               for _ in "ch")
    q_seq, (c_s, h_s) = tm.sequence(p, _t(obs), c0)
    (c_u, h_u), q_unroll = sl.unroll(tm.step, p, c0, _t(obs))
    np.testing.assert_allclose(q_seq.numpy(), q_unroll.numpy(), **F32)
    np.testing.assert_allclose(h_s.numpy(), h_u.numpy(), **F32)
    np.testing.assert_allclose(c_s.numpy(), c_u.numpy(), **F32)
    if kind == "mlp":  # against the reference's scan over flax
        (cj, hj), qj = jsl.unroll(jm.apply, jp,
                                  tuple(np.asarray(c) for c in c0), obs)
        np.testing.assert_allclose(q_seq.numpy(), np.asarray(qj), **F32)
        np.testing.assert_allclose(h_s.numpy(), np.asarray(hj), **F32)


def test_port_init_spreads_like_flax():
    gen = torch.Generator().manual_seed(0)
    tm = DrqnMlpModel(A, 64, hidden_dim=256, lstm_dim=128, generator=gen)
    sd = tm.state_dict()
    # LeCun normal: std sqrt(1 / fan_in), truncated at two std
    w = sd["fc.weight"]
    assert abs(float(w.std()) - (1 / 64) ** 0.5) < 0.1 * (1 / 64) ** 0.5
    assert float(w.abs().max()) <= 2 * (1 / 64) ** 0.5 / 0.8796 + 1e-6
    H = 128
    for k in range(4):  # one orthogonal matrix a gate
        g = sd["lstm.weight_hh"][k * H:(k + 1) * H]
        np.testing.assert_allclose((g @ g.t()).numpy(), np.eye(H),
                                   atol=1e-4)
    for name in ("fc.bias", "head.bias", "lstm.bias"):
        assert not sd[name].any()
    again = DrqnMlpModel(A, 64, hidden_dim=256, lstm_dim=128,
                         generator=torch.Generator().manual_seed(0))
    for k, v in again.state_dict().items():
        assert torch.equal(v, sd[k])


def test_value_rescale_pair_matches_jax():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(size=200) * 50.0,
                        [0.0, -1.0, 1e-4, 1e3]]).astype(np.float32)
    h = sl.value_rescale(_t(x))
    np.testing.assert_allclose(h.numpy(), np.asarray(jsl.value_rescale(x)),
                               rtol=1e-6, atol=1e-7)
    inv = sl.value_unrescale(h)
    # the inverse squares a difference of near-equal square roots scaled
    # by 1 / (2 eps) = 500: XLA's fused fp32 arithmetic and torch's part
    # in the last few bits, which that scale lifts to about 4e-5
    np.testing.assert_allclose(
        inv.numpy(), np.asarray(jsl.value_unrescale(np.asarray(h))),
        rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(inv.numpy(), x, rtol=1e-3, atol=1e-3)


def test_unpack_frame_stacks_is_exact():
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 255, (3, 7 + 4, 6, 6)).astype(np.uint8)
    got = sl.unpack_frame_stacks(_t(frames), 4, 7).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jsl.unpack_frame_stacks(frames, 4, 7)))
    assert got.shape == (3, 8, 4, 6, 6)


def _returns(boot, r, d, m, nstep, gamma):
    got = sl.nstep_window_returns(_t(boot), _t(r), _t(d), _t(m),
                                  nstep=nstep, gamma=gamma).numpy()
    want = np.asarray(jsl.nstep_window_returns(boot, r, d, m, nstep=nstep,
                                               gamma=gamma))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    return got


@pytest.mark.parametrize("nstep", [1, 3, 5])
def test_nstep_window_returns_match_jax(nstep):
    rng = np.random.default_rng(nstep)
    L, B = 9, 6
    r = rng.normal(size=(L, B)).astype(np.float32)
    boot = rng.normal(size=(L + 1, B)).astype(np.float32)
    d = (rng.random((L, B)) < 0.15).astype(np.float32)
    n_valid = rng.integers(1, L + 1, B)
    m = (np.arange(L)[:, None] < n_valid[None, :]).astype(np.float32)
    _returns(boot, r, d, m, nstep, 0.97)


def test_nstep_window_terminal_and_truncation_cases():
    # the reference's hand cases (tests/test_sequence.py:101-235), L 4
    g = 0.5
    # a terminal at t=1: no bootstrap past it
    got = _returns(np.full((5, 1), 7.0, np.float32),
                   np.array([[1.0], [10.0], [0.0], [0.0]], np.float32),
                   np.array([[0.0], [1.0], [0.0], [0.0]], np.float32),
                   np.array([[1.0], [1.0], [0.0], [0.0]], np.float32), 3, g)
    assert got[0, 0] == pytest.approx(1 + g * 10)
    assert got[1, 0] == pytest.approx(10.0)
    # a truncated tail (no terminal): the bootstrap at n_valid
    boot = np.array([[1.0], [2.0], [7.0], [7.0], [7.0]], np.float32)
    got = _returns(boot, np.array([[1.0], [1.0], [0.0], [0.0]], np.float32),
                   np.zeros((4, 1), np.float32),
                   np.array([[1.0], [1.0], [0.0], [0.0]], np.float32), 3, g)
    assert got[0, 0] == pytest.approx(1 + g * 1 + g * g * 7)
    assert got[1, 0] == pytest.approx(1 + g * 7)
