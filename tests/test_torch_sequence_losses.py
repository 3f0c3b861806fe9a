"""The port's DRQN update (ops/sequence_losses.build_drqn_train_step)
against the JAX package's, on the same weights (``convert.convert_drqn``)
and the same numpy segment batches:

- ``drqn-mlp`` (fp32) over three chained updates, with burn-in 2 and 0 and
  double DQN on and off, on segments with masked tails, terminals and
  IS weights: the loss, q_mean and grad norm of each update, the sequence
  priorities, and the params, target params and Adam moments after
  Adam, within rtol 1e-4 and atol 1e-5 (the same fp32 math in another
  summation order);
- ``drqn-cnn`` (bf16 torso, fp32 LSTM) on frame-packed 84 x 84 segments,
  one update: loss and priorities within rtol 2e-2 (bf16); the gradient,
  read as Adam's first moment (0.1 g after one step), per leaf within
  5e-2 of the reference's norm on the bf16 torso's leaves and 1e-4 on
  the fp32 LSTM's and head's; and each leaf's param step within half
  its norm of the reference's (no step reads 1, a reversed one 2; Adam's
  normalised step turns a bf16-sized change of a near-zero gradient
  into a sign flip of size 2 lr, which moves a few elements only);
- a guard-skipped update (a NaN reward): ``learner/skipped`` 1, the state
  unchanged, the priorities zero, as the JAX step;
- the reference's hand-computed n-step cases (tests/test_sequence.py:
  101-235) through the port's step with a linear "recurrent" model:
  window targets, a terminal cutting the bootstrap, and a truncated
  tail bootstrapping from the stored successor obs."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pytorch_distributed_tpu.memory.sequence_replay import (
    SegmentBatch as JaxSegmentBatch,
)
from pytorch_distributed_tpu.models.drqn import (
    DrqnCnnModel as JaxCnn, DrqnMlpModel as JaxMlp,
)
from pytorch_distributed_tpu.ops import losses as jlosses
from pytorch_distributed_tpu.ops import sequence_losses as jsl
from pytorch_distributed_tpu_torch.convert import convert_drqn
from pytorch_distributed_tpu_torch.memory.sequence_replay import (
    SegmentBatch,
)
from pytorch_distributed_tpu_torch.models.drqn import (
    DrqnCnnModel, DrqnMlpModel,
)
from pytorch_distributed_tpu_torch.ops.losses import (
    SKIPPED_KEY, init_train_state, make_optimizer,
)
from pytorch_distributed_tpu_torch.ops.sequence_losses import (
    build_drqn_train_step,
)

OBS, A, HID, LSTM, B, T, NSTEP, LR = 5, 3, 16, 8, 4, 8, 3, 1e-3
TOL = dict(rtol=1e-4, atol=1e-5)
METRICS = ("learner/critic_loss", "learner/q_mean", "learner/grad_norm")


def _segments(seed: int, obs_shape, obs_dtype=np.float32, b: int = B,
              t: int = T, width: int = LSTM) -> dict:
    rng = np.random.default_rng(seed)
    if obs_dtype == np.uint8:
        obs = rng.integers(0, 255, (b, *obs_shape)).astype(np.uint8)
    else:
        obs = rng.normal(size=(b, *obs_shape)).astype(np.float32)
    n_valid = rng.integers(t // 2, t + 1, b)
    mask = (np.arange(t)[None, :] < n_valid[:, None]).astype(np.float32)
    terminal = ((rng.random((b, t)) < 0.1) * mask).astype(np.float32)
    return dict(
        obs=obs, action=rng.integers(0, A, (b, t)).astype(np.int32),
        reward=(rng.normal(size=(b, t)) * 3.0 * mask).astype(np.float32),
        terminal=terminal, mask=mask,
        c0=(0.3 * rng.normal(size=(b, width))).astype(np.float32),
        h0=(0.3 * rng.normal(size=(b, width))).astype(np.float32),
        weight=rng.uniform(0.2, 1.0, b).astype(np.float32),
        index=np.arange(b, dtype=np.int32))


def _port_batch(d: dict) -> SegmentBatch:
    return SegmentBatch(**{k: torch.from_numpy(v) for k, v in d.items()})


def _steps(jmodel, jp, model, p, burn_in, double, packed=0, tx_lr=LR):
    kw = dict(burn_in=burn_in, nstep=NSTEP, gamma=0.99,
              enable_double=double, target_model_update=2,
              rescale_values=True, priority_eta=0.9, packed_frames=packed,
              guard=True)
    jtx = jlosses.make_optimizer(tx_lr)
    jstate = jlosses.init_train_state(jp, jtx)
    jstep = jax.jit(jsl.build_drqn_train_step(jmodel.apply, jtx, **kw))
    state = init_train_state(p)
    step = build_drqn_train_step(model, make_optimizer(tx_lr), **kw)
    return jstate, jstep, state, step


def _tree_close(port: dict, jtree, shape=(), **tol) -> None:
    want = convert_drqn(jax.tree_util.tree_map(np.asarray, jtree), shape)
    for k, v in want.items():
        np.testing.assert_allclose(port[k].numpy(), v.numpy(), err_msg=k,
                                   **tol)


@pytest.mark.parametrize("burn_in,double", [(2, True), (0, True),
                                            (2, False)])
def test_mlp_step_matches_jax(burn_in, double):
    jmodel = JaxMlp(action_space=A, hidden_dim=HID, lstm_dim=LSTM)
    jp = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS)))
    model = DrqnMlpModel(A, OBS, HID, LSTM, init_weights=False)
    jstate, jstep, state, step = _steps(jmodel, jp, model, convert_drqn(jp),
                                        burn_in, double)
    for i in range(3):
        d = _segments(10 + i, (T + 1, OBS))
        jstate, jm, jpr = jstep(jstate, JaxSegmentBatch(**d))
        state, m, pr = step(state, _port_batch(d))
        for k in METRICS:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=k,
                                       **TOL)
        assert float(m[SKIPPED_KEY]) == float(jm[SKIPPED_KEY]) == 0.0
        np.testing.assert_allclose(pr.numpy(), np.asarray(jpr), **TOL)
    assert int(state.step) == int(jstate.step) == 3
    _tree_close(state.params, jstate.params, **TOL)
    _tree_close(state.target_params, jstate.target_params, **TOL)
    adam = jstate.opt_state[0][0]  # chain(adam) -> ScaleByAdamState
    _tree_close(state.opt_state.mu, adam.mu, **TOL)
    _tree_close(state.opt_state.nu, adam.nu, rtol=1e-4, atol=1e-9)


def test_cnn_packed_step_matches_jax_in_bf16():
    frame, width, t = (4, 84, 84), 32, 6
    jmodel = JaxCnn(action_space=A, lstm_dim=width)
    jp = jmodel.init(jax.random.PRNGKey(1),
                     jnp.zeros((1, *frame), jnp.uint8))
    model = DrqnCnnModel(A, frame, lstm_dim=width, init_weights=False)
    lr = 1e-4
    p0 = convert_drqn(jp, frame)
    start = {k: v.clone() for k, v in p0.items()}
    jstate, jstep, state, step = _steps(jmodel, jp, model, p0, 2, True,
                                        packed=4, tx_lr=lr)
    d = _segments(20, (t + 4, 84, 84), np.uint8, b=2, t=t, width=width)
    jstate, jm, jpr = jstep(jstate, JaxSegmentBatch(**d))
    state, m, pr = step(state, _port_batch(d))
    for k in METRICS:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-2,
                                   atol=1e-4, err_msg=k)
    np.testing.assert_allclose(pr.numpy(), np.asarray(jpr), rtol=2e-2,
                               atol=1e-4)
    adam = jstate.opt_state[0][0]  # chain(adam) -> ScaleByAdamState
    mu = convert_drqn(jax.tree_util.tree_map(np.asarray, adam.mu), frame)
    params = convert_drqn(jax.tree_util.tree_map(np.asarray, jstate.params),
                          frame)
    for k, want in mu.items():
        tol = 5e-2 if k.startswith(("conv", "fc")) else 1e-4
        got = state.opt_state.mu[k].double()
        assert float((got - want.double()).norm()) <= tol * float(
            want.double().norm()), k
        ours = state.params[k].double() - start[k].double()
        theirs = params[k].double() - start[k].double()
        assert float((ours - theirs).norm()) <= 0.5 * float(
            theirs.norm()), k


def test_guard_skips_a_nan_update_like_jax():
    jmodel = JaxMlp(action_space=A, hidden_dim=HID, lstm_dim=LSTM)
    jp = jmodel.init(jax.random.PRNGKey(2), jnp.zeros((1, OBS)))
    model = DrqnMlpModel(A, OBS, HID, LSTM, init_weights=False)
    jstate, jstep, state, step = _steps(jmodel, jp, model, convert_drqn(jp),
                                        2, True)
    d = _segments(30, (T + 1, OBS))
    d["reward"][1, 3] = np.nan
    d["mask"][1, 3] = 1.0
    jnew, jm, jpr = jstep(jstate, JaxSegmentBatch(**d))
    new, m, pr = step(state, _port_batch(d))
    assert float(m[SKIPPED_KEY]) == float(jm[SKIPPED_KEY]) == 1.0
    assert not pr.any() and not np.asarray(jpr).any()
    assert int(new.step) == int(jnew.step) == 0
    for k, v in state.params.items():
        assert torch.equal(new.params[k], v)
        assert torch.equal(new.opt_state.mu[k], state.opt_state.mu[k])


class _Linear:
    """q(obs) = obs @ w, a "recurrent" model that keeps its carry: the
    targets of the reference's hand cases."""

    @staticmethod
    def sequence(params, obs_tm, carry):
        return obs_tm @ params["w"], carry


def _hand_case(obs, reward, terminal, mask, w, nstep):
    step = build_drqn_train_step(
        _Linear(), make_optimizer(0.0), burn_in=0, nstep=nstep, gamma=0.5,
        enable_double=False, target_model_update=10 ** 9,
        rescale_values=False, priority_eta=1.0)
    state = init_train_state({"w": torch.tensor(w, dtype=torch.float32)})
    t = reward.shape[1]
    batch = SegmentBatch(
        obs=torch.tensor(obs), action=torch.zeros((1, t), dtype=torch.int32),
        reward=torch.tensor(reward), terminal=torch.tensor(terminal),
        mask=torch.tensor(mask), c0=torch.zeros((1, 1)),
        h0=torch.zeros((1, 1)), weight=torch.ones(1),
        index=torch.zeros(1, dtype=torch.int64))
    return float(step(state, batch)[2][0])


def test_hand_computed_window_targets():
    eye = np.eye(1, 3, dtype=np.float32)  # q(obs)[0] = obs, else 0
    obs = np.arange(5, dtype=np.float32).reshape(1, 5, 1)
    ones = np.ones((1, 4), np.float32)
    got = _hand_case(obs, np.array([[1.0, 2.0, 3.0, 4.0]], np.float32),
                     0 * ones, ones, eye, 2)
    assert got == pytest.approx(4.0, abs=1e-5)
    # a terminal at t=1 cuts the bootstrap: max |td| is r_1 = 10
    got = _hand_case(np.ones((1, 5, 1), np.float32),
                     np.array([[1.0, 10.0, 0.0, 0.0]], np.float32),
                     np.array([[0.0, 1.0, 0.0, 0.0]], np.float32),
                     np.array([[1.0, 1.0, 0.0, 0.0]], np.float32),
                     0 * eye, 3)
    assert got == pytest.approx(10.0, abs=1e-5)
    # a truncated tail bootstraps from the successor obs (7) after it
    got = _hand_case(np.array([[[1.0], [2.0], [7.0], [7.0], [7.0]]],
                              np.float32),
                     np.array([[1.0, 1.0, 0.0, 0.0]], np.float32),
                     np.zeros((1, 4), np.float32),
                     np.array([[1.0, 1.0, 0.0, 0.0]], np.float32), eye, 3)
    assert got == pytest.approx(2.5, abs=1e-5)
