"""The port's DQN update (ops/losses.py) against the JAX package's
``build_train_state_and_step`` on the same weights (converted with
``convert.convert_dqn_cnn``) and the same numpy batches, in fp32: after one
step and after several, with and without double-DQN, it compares the
params, the target net, Adam's moments and step count, |TD| and the
metrics; and a non-finite batch is skipped by both with the state left as
it was.  Tolerances: rtol 1e-4 with atol 1e-5 on tensors (the same fp32
math in another summation order; Adam maps a near-zero gradient's noise to
at most about lr/100), 1e-4 on the metrics."""

import functools

import numpy as np
import pytest

import jax
import torch

from pytorch_distributed_tpu.config import build_options as jax_options
from pytorch_distributed_tpu.factory import (
    EnvSpec as JaxEnvSpec, build_model as jax_build_model,
    build_train_state_and_step as jax_state_and_step,
    init_params as jax_init_params,
)
from pytorch_distributed_tpu.utils.experience import Batch as JaxBatch
from pytorch_distributed_tpu_torch.config import build_options
from pytorch_distributed_tpu_torch.convert import convert_dqn_cnn
from pytorch_distributed_tpu_torch.factory import (
    EnvSpec, build_model, build_train_state_and_step,
)
from pytorch_distributed_tpu_torch.ops.losses import SKIPPED_KEY
from pytorch_distributed_tpu_torch.utils.experience import Batch

FRAME = (4, 44, 44)  # conv stack 10x10 -> 4x4 -> 2x2
ACTIONS, B = 6, 4
OVERRIDES = dict(compute_dtype="float32", target_model_update=2)  # lr 1e-4


@functools.lru_cache(maxsize=None)  # both steps are pure: safe to share
def _setups(enable_double: bool):
    jopt = jax_options(12, enable_double=enable_double, **OVERRIDES)
    jspec = JaxEnvSpec(state_shape=FRAME, discrete=True,
                       num_actions=ACTIONS, action_dim=0, norm_val=255.0)
    jmodel = jax_build_model(jopt, jspec)
    jparams = jax_init_params(jopt, jspec, jmodel, seed=0)
    jstate, jstep = jax_state_and_step(jopt, jspec, jmodel, jparams)

    opt = build_options(12, device="cpu", enable_double=enable_double,
                        **OVERRIDES)
    model = build_model(opt, EnvSpec(FRAME, ACTIONS, 255.0))
    sd = convert_dqn_cnn(jax.device_get(jparams), FRAME)
    state, step = build_train_state_and_step(opt, model, sd)
    return jstate, jax.jit(jstep), state, step


def _batch(seed: int, nan_reward: bool = False):
    rng = np.random.default_rng(seed)
    cols = dict(
        state0=rng.integers(0, 255, (B, *FRAME)).astype(np.uint8),
        action=rng.integers(0, ACTIONS, B).astype(np.int32),
        reward=rng.normal(size=B).astype(np.float32),
        gamma_n=np.full(B, 0.99 ** 5, np.float32),
        state1=rng.integers(0, 255, (B, *FRAME)).astype(np.uint8),
        terminal1=(rng.random(B) < 0.3).astype(np.float32),
        weight=rng.uniform(0.2, 1.0, B).astype(np.float32),
        index=np.arange(B, dtype=np.int32))
    if nan_reward:
        cols["reward"][1] = np.nan
    return (JaxBatch(**cols),
            Batch(**{k: torch.from_numpy(v.copy()) for k, v in cols.items()}))


def _close(port: dict, ref_tree, what: str):
    ref = convert_dqn_cnn(jax.device_get(ref_tree), FRAME)
    for k, v in ref.items():
        np.testing.assert_allclose(port[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=f"{what} {k}")


def _compare(jstate, state):
    adam = jstate.opt_state[0][0]
    _close(state.params, jstate.params, "params")
    _close(state.target_params, jstate.target_params, "target")
    _close(state.opt_state.mu, adam.mu, "adam mu")
    _close(state.opt_state.nu, adam.nu, "adam nu")
    assert int(state.opt_state.count) == int(adam.count)
    assert int(state.step) == int(jstate.step)


@pytest.mark.parametrize("enable_double", [False, True])
@pytest.mark.parametrize("steps", [1, 3])
def test_update_matches_jax(enable_double, steps):
    jstate, jstep, state, step = _setups(enable_double)
    for s in range(steps):
        jb, tb = _batch(s)
        jstate, jm, jtd = jstep(jstate, jb)
        state, m, td = step(state, tb)
        np.testing.assert_allclose(td.numpy(), np.asarray(jtd), rtol=1e-4,
                                   atol=1e-5)
        for key in ("learner/critic_loss", "learner/q_mean",
                    "learner/grad_norm", SKIPPED_KEY):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-4, atol=1e-6, err_msg=key)
    _compare(jstate, state)


def test_non_finite_step_is_skipped_like_jax():
    jstate, jstep, state, step = _setups(False)
    jb, tb = _batch(0)
    jstate, _, _ = jstep(jstate, jb)
    state, _, _ = step(state, tb)
    before = {k: v.clone() for k, v in state.params.items()}
    jb, tb = _batch(1, nan_reward=True)
    jstate, jm, jtd = jstep(jstate, jb)
    state, m, td = step(state, tb)
    assert float(m[SKIPPED_KEY]) == float(jm[SKIPPED_KEY]) == 1.0
    assert not td.any() and not np.asarray(jtd).any()
    assert int(state.step) == 1
    for k, v in before.items():
        assert torch.equal(state.params[k], v), k
    _compare(jstate, state)
