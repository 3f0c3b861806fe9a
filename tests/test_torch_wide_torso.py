"""CONFIGS row 19's wide residual torso (models/dqn_cnn_wide.py) against
the JAX package's flax ``DqnCnnWideModel``, on converted weights
(``convert.convert_dqn_cnn_wide``) and the same numpy frames, at width 8
and 84 x 84 (the pools pad (0, 1), (0, 1) and (1, 1) there):

- the forward in fp32 within atol 1e-5 (rtol 1e-5), and in bf16 within
  3e-2 of the output scale (the largest |Q|): both frameworks round to
  bf16 at the same points, but XLA and torch accumulate the convolutions
  in other orders, so a product can land one bf16 step (2^-8 relative)
  apart, and the error grows through 15 layers;
- the converter's round trip (``flax_leaves`` gives back the flax leaves
  in ``ravel_pytree`` order);
- row 19's fused PER update (dispatches of 3 sub-steps, batch 8, width 8,
  fp32) against the JAX step through its Pallas draw in interpret mode:
  the loss and the priorities rtol 1e-4, and the params rtol 1e-4 / atol
  1e-5 on all but at most 1e-4 of their elements.  Adam moves a weight by
  about ``lr`` a step whatever the size of its gradient, so a weight whose
  gradient is ~0 (the 991,232 weights of ``fc`` at width 8 hold some)
  moves the other way when float rounding flips that gradient's sign:
  those few are held to 2 ``lr`` per update;
- ``build_model`` and ``build_options`` for row 19, and the
  ``model_type`` override on row 12."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.flatten_util import ravel_pytree

from pytorch_distributed_tpu.config import build_options as jax_options
from pytorch_distributed_tpu.factory import (
    EnvSpec as JaxEnvSpec, build_model as jax_build_model,
    build_train_state_and_step as jax_state_and_step,
    init_params as jax_init_params,
)
from pytorch_distributed_tpu.memory.device_per import (
    DevicePerReplay as JaxDevicePerReplay,
)
from pytorch_distributed_tpu.models.dqn_cnn_wide import (
    DqnCnnWideModel as JaxWide,
)
from pytorch_distributed_tpu.ops.pallas_sampling import hierarchical_sample
from pytorch_distributed_tpu.utils.experience import (
    Transition as JaxTransition,
)
from pytorch_distributed_tpu_torch.config import PORTED_CONFIGS, build_options
from pytorch_distributed_tpu_torch.convert import (
    convert_dqn_cnn_wide, flax_leaves,
)
from pytorch_distributed_tpu_torch.factory import (
    MODELS, EnvSpec, build_model, build_train_state_and_step, probe_env,
)
from pytorch_distributed_tpu_torch.memory.device_per import DevicePerReplay
from pytorch_distributed_tpu_torch.models import dqn_cnn_wide as wide
from pytorch_distributed_tpu_torch.utils.experience import Transition

FRAME = (4, 84, 84)
ACTIONS, WIDTH = 6, 8
CAPACITY, ROWS, B, K = 64, 48, 8, 3
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}
torch.set_num_threads(1)


def _frames(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, (n, *FRAME)).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _flax_params(seed: int = 0):
    model = JaxWide(action_space=ACTIONS, width=WIDTH,
                    compute_dtype=jnp.float32)
    return jax.device_get(model.init(jax.random.PRNGKey(seed),
                                     jnp.zeros((1, *FRAME), jnp.uint8)))


def _port_model(dtype) -> wide.DqnCnnWideModel:
    model = wide.DqnCnnWideModel(ACTIONS, FRAME, width=WIDTH,
                                 orthogonal_init=False, compute_dtype=dtype)
    model.load_state_dict(convert_dqn_cnn_wide(_flax_params(), FRAME))
    return model


def test_pool_pads_are_flax_same():
    assert [wide.same_pool_pads(n) for n in (84, 42, 21)] == [
        (0, 1), (0, 1), (1, 1)]
    assert wide.torso_out_hw(84, 84) == (11, 11)
    x = np.random.default_rng(1).normal(size=(2, 3, 21, 42)).astype(
        np.float32)
    ref = jax.device_get(__import__("flax").linen.max_pool(
        jnp.asarray(x.transpose(0, 2, 3, 1)), (3, 3), strides=(2, 2),
        padding="SAME")).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(
        wide._max_pool_same(torch.from_numpy(x)).numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_flax(dtype):
    jdt, tdt = _DT[dtype]
    obs = _frames(3)
    jq = np.asarray(JaxWide(action_space=ACTIONS, width=WIDTH,
                            compute_dtype=jdt).apply(_flax_params(),
                                                     jnp.asarray(obs)))
    with torch.no_grad():
        q = _port_model(tdt)(torch.from_numpy(obs)).numpy()
    assert q.dtype == np.float32 and q.shape == (3, ACTIONS)
    if dtype == "float32":
        np.testing.assert_allclose(q, jq, rtol=1e-5, atol=1e-5)
    else:
        scale = float(np.abs(jq).max())
        np.testing.assert_allclose(q, jq, rtol=0, atol=3e-2 * scale)


def test_converter_round_trip():
    sd = convert_dqn_cnn_wide(_flax_params(), FRAME)
    flat, _unravel = ravel_pytree(_flax_params())
    leaves = flax_leaves(sd, FRAME)
    got = np.concatenate([v.detach().reshape(-1).numpy()
                          for _k, v in leaves])
    np.testing.assert_array_equal(got, np.asarray(flat))
    names = [k for k, _v in leaves]
    assert names[0] == "Conv_0/bias" and names[-1] == "_ResBlock_5/Conv_1/kernel"
    assert set(sd) == set(_port_model(torch.float32).state_dict())


def _chunk(seed: int = 0):
    rng = np.random.default_rng(seed)
    return dict(
        state0=rng.integers(0, 255, (ROWS, *FRAME)).astype(np.uint8),
        action=rng.integers(0, ACTIONS, ROWS).astype(np.int32),
        reward=rng.normal(size=ROWS).astype(np.float32),
        gamma_n=np.full(ROWS, 0.99 ** 5, np.float32),
        state1=rng.integers(0, 255, (ROWS, *FRAME)).astype(np.uint8),
        terminal1=(rng.random(ROWS) < 0.1).astype(np.float32))


def test_fused_per_update_matches_jax():
    """Row 19's update at width 8 in fp32, the learner's fused PER step
    (the module's forward; no torso kernel on this row)."""
    over = dict(compute_dtype="float32", cnn_wide_width=WIDTH,
                target_model_update=2)
    jopt = jax_options(19, pallas_interpret=True, **over)
    jspec = JaxEnvSpec(state_shape=FRAME, discrete=True,
                       num_actions=ACTIONS, action_dim=0, norm_val=255.0)
    jmodel = jax_build_model(jopt, jspec)
    jparams = jax_init_params(jopt, jspec, jmodel, seed=0)
    jstate, jstep = jax_state_and_step(jopt, jspec, jmodel, jparams)
    cols = _chunk()
    jring = JaxDevicePerReplay(CAPACITY, FRAME)
    jring.feed_chunk(JaxTransition(**cols))
    jring._draw_fn = functools.partial(hierarchical_sample, interpret=True)
    jfused = jring.build_fused_step(jstep, B, donate=False,
                                    steps_per_call=K)
    ring = DevicePerReplay(CAPACITY, FRAME, device="cpu")
    ring.feed_chunk(Transition(**cols))

    opt = build_options(19, device="cpu", **over)
    model = build_model(opt, EnvSpec(FRAME, ACTIONS, 255.0))
    assert isinstance(model, wide.DqnCnnWideModel)
    state, step = build_train_state_and_step(
        opt, model, convert_dqn_cnn_wide(jax.device_get(jparams), FRAME))
    fused = ring.build_fused_step(step, B, steps_per_call=K)
    beta = ring.beta(0)
    for dispatch in range(2):
        keys = jax.random.split(jax.random.PRNGKey(dispatch), K)
        jstate, jring.state, jm = jfused(jstate, jring.state, keys,
                                         np.float32(beta))
        us = torch.from_numpy(np.stack(
            [np.array(jax.random.uniform(k, (B,))) for k in keys]))
        state, m = fused(state, ring.state, us, beta)
        np.testing.assert_allclose(float(m["learner/critic_loss"]),
                                   float(jm["learner/critic_loss"]),
                                   rtol=1e-4)
    ref = convert_dqn_cnn_wide(jax.device_get(jstate.params), FRAME)
    for k, v in ref.items():
        got, want = state.params[k].numpy(), v.numpy()
        diff = np.abs(got - want)
        off = diff > 1e-5 + 1e-4 * np.abs(want)
        assert off.mean() <= 1e-4, (k, off.sum())
        assert diff.max() <= 2 * opt.agent_params.lr * 2 * K, k
    np.testing.assert_allclose(ring.state.priority.numpy(),
                               np.asarray(jring.state.priority), rtol=1e-4)
    assert int(state.step) == int(jstate.step) == 2 * K


def test_build_model_for_row_19():
    assert 19 in PORTED_CONFIGS and "dqn-cnn-wide" in MODELS
    opt = build_options(19, device="cpu")
    assert (opt.model_type, opt.memory_type) == ("dqn-cnn-wide", "device-per")
    assert opt.model_params.cnn_wide_width == 128
    spec = probe_env(opt)
    model = build_model(opt, spec, init_weights=False)
    assert isinstance(model, wide.DqnCnnWideModel)
    assert [getattr(model, f"conv{i}").out_channels for i in range(3)] == [
        128, 256, 256]
    assert model.fc.in_features == 11 * 11 * 256
    swapped = build_options(12, device="cpu", model_type="dqn-cnn-wide",
                            cnn_wide_width=WIDTH)
    assert isinstance(build_model(swapped, spec, init_weights=False),
                      wide.DqnCnnWideModel)
