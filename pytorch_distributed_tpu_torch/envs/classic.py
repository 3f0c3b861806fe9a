"""Classic-control envs without gym — the port's copy of
pytorch_distributed_tpu/envs/classic.py: ``CartPoleEnv`` (:20-83),
``PendulumEnv`` (:86-139), ``ReacherEnv`` (:142-224) and
``make_classic_env`` (:227-235).

Cart-pole balance with a discrete push left / push right: gravity 9.8,
cart mass 1.0, pole mass 0.1, half-length 0.5, force 10, Euler steps of
0.02 s; an episode ends when |x| > 2.4, |theta| > 12 degrees or after 500
steps, which is a truncation, not a failure.  Observations are float32
(x, x_dot, theta, theta_dot), reset uniformly in [-0.05, 0.05] from the
env's own seeded generator.

Pendulum swing-up (CONFIGS row 2): theta'' = 3g/(2l) sin(theta) +
3/(m l^2) u with g 10, m 1, l 1, dt 0.05, |u| <= 2 and the cost theta^2 +
0.1 theta'^2 + 0.001 u^2; observation (cos, sin, theta'); 200-step
episodes, a truncation at the end.

Reacher (row 16): a two-joint planar arm steering its fingertip to a
random target, two damped torque-driven joints with decoupled inertia,
links 0.1 and 0.11; a 10-d observation (cos and sin of both joints, both
velocities / 10, the target, the fingertip's offset from it), 2 torques,
150-step episodes, ``info["solved"]`` when the fingertip ends within 5 cm.

Both continuous envs take actions in [-1, 1] and rescale them
(``ContinuousSpace.denormalize``); every step is the reference's numpy
code, so the same actions give the same floats.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from pytorch_distributed_tpu_torch.envs.base import (
    ContinuousSpace, DiscreteSpace, Env,
)


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


class PendulumEnv(Env):
    def __init__(self, env_params, process_ind: int = 0):
        super().__init__(env_params, process_ind)
        self.max_speed = 8.0
        self.max_torque = 2.0
        self.dt = 0.05
        self.g = 10.0
        self.m = 1.0
        self.l = 1.0
        self.max_steps = 200
        self.state = np.zeros(2, dtype=np.float64)
        self._steps = 0

    @property
    def state_shape(self) -> Tuple[int, ...]:
        return (3,)

    @property
    def action_space(self) -> ContinuousSpace:
        return ContinuousSpace(dim=1, low=-self.max_torque,
                               high=self.max_torque)

    def _obs(self) -> np.ndarray:
        th, thdot = self.state
        return np.array([np.cos(th), np.sin(th), thdot], dtype=np.float32)

    def _reset(self) -> np.ndarray:
        self.state = self.rng.uniform([-np.pi, -1.0], [np.pi, 1.0])
        self._steps = 0
        return self._obs()

    def _step(self, action) -> Tuple[np.ndarray, float, bool, Dict[str, Any]]:
        th, thdot = self.state
        u = float(np.squeeze(self.action_space.denormalize(action)))
        angle = ((th + np.pi) % (2 * np.pi)) - np.pi
        cost = angle ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        thdot = thdot + (3.0 * self.g / (2.0 * self.l) * np.sin(th)
                         + 3.0 / (self.m * self.l ** 2) * u) * self.dt
        thdot = np.clip(thdot, -self.max_speed, self.max_speed)
        th = th + thdot * self.dt
        self.state = np.array([th, thdot])
        self._steps += 1
        terminal = self._steps >= self.max_steps
        # a fixed-length episode: its end is a time limit
        info: Dict[str, Any] = {"truncated": True} if terminal else {}
        return self._obs(), float(-cost), terminal, info


class ReacherEnv(Env):
    L1, L2 = 0.1, 0.11
    MAX_TORQUE = 1.0
    DT = 0.05
    DAMPING = 0.5
    INERTIA = 0.1
    MAX_SPEED = 4.0

    def __init__(self, env_params, process_ind: int = 0):
        super().__init__(env_params, process_ind)
        self.max_steps = 150
        self.q = np.zeros(2)       # joint angles
        self.qdot = np.zeros(2)    # joint velocities
        self.target = np.zeros(2)
        self._steps = 0

    @property
    def state_shape(self) -> Tuple[int, ...]:
        return (10,)

    @property
    def action_space(self) -> ContinuousSpace:
        return ContinuousSpace(dim=2, low=-self.MAX_TORQUE,
                               high=self.MAX_TORQUE)

    def _fingertip(self) -> np.ndarray:
        x = self.L1 * np.cos(self.q[0]) \
            + self.L2 * np.cos(self.q[0] + self.q[1])
        y = self.L1 * np.sin(self.q[0]) \
            + self.L2 * np.sin(self.q[0] + self.q[1])
        return np.array([x, y])

    def _obs(self) -> np.ndarray:
        delta = self._fingertip() - self.target
        return np.concatenate([
            np.cos(self.q), np.sin(self.q), self.qdot * 0.1,
            self.target, delta,
        ]).astype(np.float32)

    def _reset(self) -> np.ndarray:
        self.q = self.rng.uniform(-np.pi, np.pi, size=2)
        self.qdot = self.rng.uniform(-0.5, 0.5, size=2)
        # the target uniform over the reachable disc (radius L1 + L2)
        r = np.sqrt(self.rng.uniform(0.0, 1.0)) * (self.L1 + self.L2)
        phi = self.rng.uniform(-np.pi, np.pi)
        self.target = np.array([r * np.cos(phi), r * np.sin(phi)])
        self._steps = 0
        return self._obs()

    def _step(self, action) -> Tuple[np.ndarray, float, bool, Dict[str, Any]]:
        u = self.action_space.denormalize(np.asarray(action).reshape(2))
        self.qdot = self.qdot + self.DT * (
            u - self.DAMPING * self.qdot) / self.INERTIA
        self.qdot = np.clip(self.qdot, -self.MAX_SPEED, self.MAX_SPEED)
        self.q = self.q + self.DT * self.qdot
        self._steps += 1
        dist = float(np.linalg.norm(self._fingertip() - self.target))
        reward = -(dist + 0.01 * float(np.square(u).sum()))
        terminal = self._steps >= self.max_steps
        info: Dict[str, Any] = {}
        if terminal:
            # a time limit, not a death state: the n-step tail bootstraps
            info["truncated"] = True
            info["solved"] = dist < 0.05
        return self._obs(), reward, terminal, info


CLASSIC_GAMES = {"cartpole": CartPoleEnv, "pendulum": PendulumEnv,
                 "reacher": ReacherEnv}


def make_classic_env(env_params, process_ind: int = 0) -> Env:
    if env_params.game not in CLASSIC_GAMES:
        raise ValueError(f"unknown classic game: {env_params.game}")
    return CLASSIC_GAMES[env_params.game](env_params, process_ind)
