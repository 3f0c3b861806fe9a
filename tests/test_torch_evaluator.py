"""The evaluator's greedy episodes and the tester, port against reference.

- ``greedy_episodes``: the JAX evaluator's (agents/evaluator.py:46-104)
  and the port's, on the same converted weights and a Pong simulator of
  the same seed in ``eval()`` mode, episodes capped at 200 agent steps.
  In fp32 compute the episode stats and every action must match exactly.
- bf16 compute: the Q values of both models over 256 Pong observations
  agree within the bf16 tolerance ``TOL_BF16`` (the spacing of bf16 at 1,
  2^-7, times the largest |Q|), and wherever the reference's margin
  between its best and second-best action exceeds twice that tolerance,
  the greedy actions are the same.
- the tester: ``run_tester`` on a params file written by the port's
  checkpoint module returns the stats of the greedy episodes on the same
  weights.
"""

import numpy as np
import pytest

import jax
import torch

from pytorch_distributed_tpu.agents.evaluator import (
    greedy_episodes as jax_greedy_episodes,
)
from pytorch_distributed_tpu.config import build_options as jax_options
from pytorch_distributed_tpu.envs.pong_sim import PongSimEnv as JaxPongSim
from pytorch_distributed_tpu.factory import (
    EnvSpec as JaxEnvSpec, build_model as jax_build_model,
    init_params as jax_init_params,
)
from pytorch_distributed_tpu_torch.agents.evaluator import greedy_episodes
from pytorch_distributed_tpu_torch.agents.tester import run_tester
from pytorch_distributed_tpu_torch.config import build_options
from pytorch_distributed_tpu_torch.convert import convert_dqn_cnn
from pytorch_distributed_tpu_torch.envs.pong_sim import PongSimEnv
from pytorch_distributed_tpu_torch.factory import (
    EnvSpec, build_model, module_apply,
)
from pytorch_distributed_tpu_torch.utils import checkpoint

FRAME, ACTIONS, EARLY_STOP, SLOT = (4, 84, 84), 6, 200, 9
TOL_BF16 = 2.0 ** -7  # times max |Q|


class _Recording:
    """An env that records the actions it is stepped with."""

    def __init__(self, env):
        self.env, self.actions = env, []

    def step(self, action):
        self.actions.append(int(action))
        return self.env.step(action)

    def __getattr__(self, name):
        return getattr(self.env, name)


def _pair(compute_dtype: str, seed: int = 3):
    jopt = jax_options(12, compute_dtype=compute_dtype,
                       early_stop=EARLY_STOP)
    jspec = JaxEnvSpec(state_shape=FRAME, discrete=True, num_actions=ACTIONS,
                       action_dim=0, norm_val=255.0)
    jmodel = jax_build_model(jopt, jspec)
    jparams = jax_init_params(jopt, jspec, jmodel, seed=seed)
    opt = build_options(12, device="cpu", compute_dtype=compute_dtype,
                        early_stop=EARLY_STOP)
    spec = EnvSpec(FRAME, ACTIONS, 255.0)
    params = convert_dqn_cnn(jax.device_get(jparams), FRAME)
    return (jopt, jspec, jmodel, jparams), (opt, spec, params)


def _envs(jopt, opt):
    jenv, env = JaxPongSim(jopt.env_params, SLOT), PongSimEnv(opt.env_params,
                                                               SLOT)
    jenv.eval()
    env.eval()
    return _Recording(jenv), _Recording(env)


def test_greedy_episodes_match_in_fp32():
    (jopt, jspec, jmodel, jparams), (opt, spec, params) = _pair("float32")
    jenv, env = _envs(jopt, opt)
    ref = jax_greedy_episodes(jopt, jspec, jmodel, jparams, jenv, 2)
    got = greedy_episodes(opt, spec, build_model(opt, spec), params, env, 2)
    assert len(env.actions) == len(jenv.actions) > 100
    assert env.actions == jenv.actions
    assert len(set(env.actions)) > 1  # the policy does not act constantly
    assert got == ref


def test_greedy_actions_agree_in_bf16_above_the_tolerance():
    (jopt, _jspec, jmodel, jparams), (opt, spec, params) = _pair("bfloat16")
    env = PongSimEnv(opt.env_params, SLOT)
    rng = np.random.default_rng(0)
    obs = [env.reset()]
    for _ in range(255):
        o, _r, terminal, _info = env.step(int(rng.integers(ACTIONS)))
        obs.append(env.reset() if terminal else o)
    obs = np.stack(obs)
    q_ref = np.asarray(jmodel.apply(jparams, obs))
    q = module_apply(build_model(opt, spec))(params, torch.from_numpy(obs))
    q = q.detach().numpy()
    tol = TOL_BF16 * float(np.abs(q_ref).max())
    assert np.abs(q - q_ref).max() <= tol
    top2 = np.sort(q_ref, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    assert clear.sum() >= len(obs) // 2
    np.testing.assert_array_equal(q.argmax(-1)[clear],
                                  q_ref.argmax(-1)[clear])


@pytest.mark.parametrize("given", ["model_name", "path"])
def test_tester_plays_the_saved_params(tmp_path, given):
    (jopt, jspec, jmodel, jparams), (opt, spec, params) = _pair("float32")
    opt = build_options(12, device="cpu", compute_dtype="float32",
                        early_stop=EARLY_STOP, mode=2, tester_nepisodes=2,
                        root_dir=str(tmp_path), refs="run")
    path = checkpoint.save_params(checkpoint.params_path(opt.model_name),
                                  params)
    if given == "path":
        opt.model_file = path
    assert opt.model_file is not None
    out = run_tester(opt, spec)
    # the tester plays slot 0
    jenv = JaxPongSim(jopt.env_params, 0)
    jenv.eval()
    avg_steps, avg_reward, solved = jax_greedy_episodes(
        jopt, jspec, jmodel, jparams, jenv, 2)
    assert out == {"avg_steps": avg_steps, "avg_reward": avg_reward,
                   "nepisodes": 2.0, "nepisodes_solved": float(solved)}
