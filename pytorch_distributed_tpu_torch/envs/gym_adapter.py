"""Gymnasium (or legacy gym) envs behind the port's ``Env`` surface — the
port's copy of pytorch_distributed_tpu/envs/gym_adapter.py (:1-115), for
CONFIGS rows 9 (``halfcheetah``) and 10 (``humanoid``).

gym is imported when an env is made (``_import_gym``), never when this
module is: a machine without gymnasium imports the port whole and raises
only when a run asks for ``env_type`` "gym".  A ``Box`` action space
takes the [-1, 1] policy convention and is rescaled per dimension to the
space's bounds; a ``Discrete`` one passes the index.  Each reset seeds the
gym env from the slot's own generator, so a slot's episodes are the same
in every run; a time limit is flagged ``truncated`` (the n-step tail
bootstraps).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from pytorch_distributed_tpu_torch.envs.base import (
    ContinuousSpace, DiscreteSpace, Env,
)

# the CONFIGS game name -> the gym env id
GYM_IDS = {
    "pendulum": "Pendulum-v1",
    "halfcheetah": "HalfCheetah-v4",
    "humanoid": "Humanoid-v4",
    "hopper": "Hopper-v4",
    "walker2d": "Walker2d-v4",
    "ant": "Ant-v4",
    "cartpole": "CartPole-v1",
}


def _import_gym():
    """``(module, modern)``: gymnasium first, then the legacy gym."""
    try:
        import gymnasium as gym

        return gym, True
    except ImportError:
        pass
    try:
        import gym

        return gym, False
    except ImportError as e:
        raise ImportError(
            "env_type 'gym' needs gymnasium (or gym) installed, with MuJoCo "
            "for the halfcheetah and humanoid rows; the classic, fake and "
            "pong-sim envs need neither") from e


class GymEnv(Env):
    def __init__(self, env_params, process_ind: int = 0):
        super().__init__(env_params, process_ind)
        gym, self._modern = _import_gym()
        env_id = GYM_IDS.get(env_params.game, env_params.game)
        self._env = gym.make(env_id)
        if not self._modern and not hasattr(self._env, "seed"):
            # a legacy-named gym >= 0.26 speaks the gymnasium API
            self._modern = True
        self.norm_val = 1.0
        space = self._env.action_space
        if hasattr(space, "n"):
            self._space = DiscreteSpace(int(space.n))
        else:
            low = np.asarray(space.low, dtype=np.float32)
            high = np.asarray(space.high, dtype=np.float32)
            # the box's bounds may differ by dimension: _step rescales
            # with these, the space carries their extremes
            self._low, self._high = low, high
            self._space = ContinuousSpace(dim=int(np.prod(space.shape)),
                                          low=float(low.min()),
                                          high=float(high.max()))

    @property
    def state_shape(self) -> Tuple[int, ...]:
        return tuple(self._env.observation_space.shape)

    @property
    def action_space(self):
        return self._space

    def _reset(self) -> np.ndarray:
        if self._modern:
            obs, _info = self._env.reset(seed=self.seed + self._episode_seed())
        else:
            self._env.seed(self.seed + self._episode_seed())
            obs = self._env.reset()
        return np.asarray(obs, dtype=np.float32)

    def _episode_seed(self) -> int:
        return int(self.rng.integers(2 ** 20))

    def _step(self, action) -> Tuple[np.ndarray, float, bool, Dict[str, Any]]:
        if isinstance(self._space, ContinuousSpace):
            a = np.clip(np.asarray(action, np.float32).ravel(), -1.0, 1.0)
            action = self._low + (a + 1.0) * 0.5 * (self._high - self._low)
        else:
            action = int(np.asarray(action))
        if self._modern:
            obs, r, terminated, truncated, info = self._env.step(action)
            terminal = bool(terminated or truncated)
            info = dict(info)
            if truncated and not terminated:
                info["truncated"] = True
        else:
            obs, r, terminal, info = self._env.step(action)
            info = dict(info)
            if info.get("TimeLimit.truncated"):
                info["truncated"] = True
        return np.asarray(obs, dtype=np.float32), float(r), terminal, info
