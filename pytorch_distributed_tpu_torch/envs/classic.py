"""Classic-control envs without gym — the port's copy of
``CartPoleEnv`` and ``make_classic_env`` of
pytorch_distributed_tpu/envs/classic.py:20-89, :227-235 (Pendulum and
Reacher wait for the DDPG slice, ROADMAP.md Queue A).

Cart-pole balance with a discrete push left / push right: gravity 9.8,
cart mass 1.0, pole mass 0.1, half-length 0.5, force 10, Euler steps of
0.02 s; an episode ends when |x| > 2.4, |theta| > 12 degrees or after 500
steps, which is a truncation, not a failure.  Observations are float32
(x, x_dot, theta, theta_dot), reset uniformly in [-0.05, 0.05] from the
env's own seeded generator.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from pytorch_distributed_tpu_torch.envs.base import DiscreteSpace, Env


class CartPoleEnv(Env):
    def __init__(self, env_params, process_ind: int = 0):
        super().__init__(env_params, process_ind)
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.total_mass = self.masscart + self.masspole
        self.length = 0.5
        self.polemass_length = self.masspole * self.length
        self.force_mag = 10.0
        self.tau = 0.02
        self.theta_threshold = 12 * 2 * np.pi / 360
        self.x_threshold = 2.4
        self.max_steps = 500
        self.state = np.zeros(4, dtype=np.float64)
        self._steps = 0

    @property
    def state_shape(self) -> Tuple[int, ...]:
        return (4,)

    @property
    def action_space(self) -> DiscreteSpace:
        return DiscreteSpace(2)

    def _reset(self) -> np.ndarray:
        self.state = self.rng.uniform(-0.05, 0.05, size=(4,))
        self._steps = 0
        return self.state.astype(np.float32)

    def _step(self, action) -> Tuple[np.ndarray, float, bool, Dict[str, Any]]:
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if int(action) == 1 else -self.force_mag
        costheta, sintheta = np.cos(theta), np.sin(theta)
        temp = (force + self.polemass_length * theta_dot ** 2 * sintheta) \
            / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0
                           - self.masspole * costheta ** 2 / self.total_mass))
        xacc = temp - self.polemass_length * thetaacc * costheta \
            / self.total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array([x, x_dot, theta, theta_dot])
        self._steps += 1
        died = bool(abs(x) > self.x_threshold
                    or abs(theta) > self.theta_threshold)
        timed_out = self._steps >= self.max_steps
        info: Dict[str, Any] = {}
        if timed_out and not died:
            info["truncated"] = True
        return (self.state.astype(np.float32), 1.0, died or timed_out,
                info)


def make_classic_env(env_params, process_ind: int = 0) -> Env:
    if env_params.game == "cartpole":
        return CartPoleEnv(env_params, process_ind)
    raise NotImplementedError(f"classic game {env_params.game!r} is not "
                              f"ported yet (ROADMAP.md, Queue A)")
