"""DDPG's noise and envs in the port against the JAX package's copies:

- ``OrnsteinUhlenbeckProcess`` draws the reference's noise to the bit for
  the same seed, with a sigma anneal and per-env resets of the path
  (what the actor's ``on_env_reset`` does);
- ``PendulumEnv`` (row 2) and ``ReacherEnv`` (row 16) give bit-identical
  observation, reward, terminal and info streams over whole episodes
  under the same action sequence, resets included;
- ``GymEnv`` (rows 9 and 10) on ``HalfCheetah-v4`` and ``Humanoid-v4``
  equals the reference's adapter under the same seed and actions, with
  ``early_stop`` truncations inside the window; skipped where gymnasium
  or MuJoCo is not installed;
- ``build_options`` takes rows 2, 9, 10 and 16 with the reference's
  DDPG defaults, and ``probe_env`` gives their continuous action specs."""

import importlib.util

import numpy as np
import pytest

from pytorch_distributed_tpu.config import build_options as jax_options
from pytorch_distributed_tpu.envs.classic import (
    PendulumEnv as JaxPendulum, ReacherEnv as JaxReacher,
)
from pytorch_distributed_tpu.utils.random_process import (
    OrnsteinUhlenbeckProcess as JaxOU,
)
from pytorch_distributed_tpu_torch.config import (
    PORTED_CONFIGS, build_options,
)
from pytorch_distributed_tpu_torch.envs.base import ContinuousSpace
from pytorch_distributed_tpu_torch.envs.classic import (
    PendulumEnv, ReacherEnv,
)
from pytorch_distributed_tpu_torch.factory import probe_env
from pytorch_distributed_tpu_torch.utils.random_process import (
    OrnsteinUhlenbeckProcess,
)

HAVE_MUJOCO = all(importlib.util.find_spec(m) is not None
                  for m in ("gymnasium", "mujoco"))


@pytest.mark.parametrize("sigma_min", [None, 0.05], ids=["flat", "anneal"])
def test_ou_noise_is_the_references_to_the_bit(sigma_min):
    kw = dict(size=3 * 2, theta=0.15, mu=0.0, sigma=0.3, sigma_min=sigma_min,
              n_steps_annealing=50, seed=1_000_017)
    port, ref = OrnsteinUhlenbeckProcess(**kw), JaxOU(**kw)
    for t in range(120):
        if t % 37 == 36:  # env 1's episode ends: its slice restarts at x0
            for p in (port, ref):
                p.x_prev.reshape(3, -1)[1] = p.x0
        a, b = port.sample(), ref.sample()
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)
        assert port.current_sigma == ref.current_sigma
    assert port.current_sigma == (0.05 if sigma_min else 0.3)


@pytest.mark.parametrize("config,cls,jax_cls,dim", [
    (2, PendulumEnv, JaxPendulum, 1), (16, ReacherEnv, JaxReacher, 2)],
    ids=["pendulum", "reacher"])
def test_classic_streams_are_bit_identical(config, cls, jax_cls, dim):
    env, jenv = (cls(build_options(config).env_params, 3),
                 jax_cls(jax_options(config).env_params, 3))
    assert env.state_shape == jenv.state_shape
    assert env.action_space == ContinuousSpace(
        dim=jenv.action_space.dim, low=jenv.action_space.low,
        high=jenv.action_space.high)
    # past [-1, 1] too: both clip before they rescale
    actions = np.random.default_rng(config).uniform(
        -1.2, 1.2, (3 * env.max_steps, dim)).astype(np.float32)
    obs, jobs = env.reset(), jenv.reset()
    np.testing.assert_array_equal(obs, jobs)
    ends = 0
    for a in actions:
        o, r, t, info = env.step(a)
        jo, jr, jt, jinfo = jenv.step(a)
        assert o.dtype == jo.dtype == np.float32
        np.testing.assert_array_equal(o, jo)
        assert (r, t, info) == (jr, jt, jinfo)
        if t:
            ends += 1
            np.testing.assert_array_equal(env.reset(), jenv.reset())
    assert ends == 3


@pytest.mark.skipif(not HAVE_MUJOCO, reason="gymnasium/MuJoCo not installed")
@pytest.mark.parametrize("config,game,obs_dim,act_dim", [
    (9, "halfcheetah", 17, 6), (10, "humanoid", 376, 17)])
def test_gym_adapter_matches_the_references(config, game, obs_dim, act_dim):
    from pytorch_distributed_tpu.envs.gym_adapter import GymEnv as JaxGym
    from pytorch_distributed_tpu_torch.envs.gym_adapter import GymEnv

    env = GymEnv(build_options(config, early_stop=25).env_params, 1)
    jenv = JaxGym(jax_options(config, early_stop=25).env_params, 1)
    assert env.state_shape == jenv.state_shape == (obs_dim,)
    assert env.action_space.dim == jenv.action_space.dim == act_dim
    actions = np.random.default_rng(config).uniform(
        -1, 1, (60, act_dim)).astype(np.float32)
    np.testing.assert_array_equal(env.reset(), jenv.reset())
    ends = 0
    for a in actions:
        o, r, t, info = env.step(a)
        jo, jr, jt, jinfo = jenv.step(a)
        np.testing.assert_array_equal(o, jo)
        assert (r, t, info.get("truncated")) == (jr, jt,
                                                 jinfo.get("truncated"))
        if t:
            ends += 1
            np.testing.assert_array_equal(env.reset(), jenv.reset())
    assert ends >= 2


@pytest.mark.parametrize("config", [2, 9, 10, 16])
def test_ddpg_rows_build_with_the_reference_defaults(config):
    assert PORTED_CONFIGS == (1, 2, 3, 4, 6, 8, 9, 10, 12, 13, 14, 15, 16,
                              17, 18, 19)
    opt, jopt = build_options(config), jax_options(config)
    assert opt.agent_type == "ddpg" and opt.model_type == "ddpg-mlp"
    for f in ("clip_grad", "actor_sync_freq", "actor_freq", "learner_freq",
              "evaluator_freq", "learn_start", "batch_size",
              "target_model_update", "lr", "critic_lr", "ou_theta",
              "ou_sigma", "ou_mu", "ddpg_coupled_update", "lr_decay",
              "weight_decay"):
        assert getattr(opt.agent_params, f) == getattr(jopt.agent_params,
                                                       f), f
    assert opt.memory_params.state_dtype == "float32"
    if config in (2, 16) or HAVE_MUJOCO:
        spec = probe_env(opt)
        assert not spec.discrete and spec.action_shape == (spec.action_dim,)
        assert spec.action_dtype == np.float32
