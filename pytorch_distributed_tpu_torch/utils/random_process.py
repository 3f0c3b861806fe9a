"""Exploration noise — the port's copy of
pytorch_distributed_tpu/utils/random_process.py (``AnnealedGaussianProcess``
:14-33, ``OrnsteinUhlenbeckProcess`` :36-66).

The DDPG actors add an Ornstein-Uhlenbeck path to the deterministic
policy's actions: ``x' = x + theta (mu - x) dt + sigma sqrt(dt) N(0, 1)``,
with sigma annealed linearly from ``sigma`` to ``sigma_min`` over
``n_steps_annealing`` samples (never, without a ``sigma_min``).  The draws
come from ``numpy.random.default_rng(seed)``, as the reference's, so one
seed gives the same noise stream in both packages, to the bit.
"""

from __future__ import annotations

import numpy as np


class AnnealedGaussianProcess:
    """sigma linearly annealed from ``sigma`` to ``sigma_min`` over
    ``n_steps_annealing`` samples."""

    def __init__(self, mu: float, sigma: float, sigma_min: float | None,
                 n_steps_annealing: int = 1000):
        self.mu = mu
        self.sigma = sigma
        self.n_steps = 0
        if sigma_min is not None:
            self.m = -(sigma - sigma_min) / float(n_steps_annealing)
            self.c = sigma
            self.sigma_min = sigma_min
        else:
            self.m = 0.0
            self.c = sigma
            self.sigma_min = sigma

    @property
    def current_sigma(self) -> float:
        return max(self.sigma_min, self.m * self.n_steps + self.c)


class OrnsteinUhlenbeckProcess(AnnealedGaussianProcess):
    """One OU path of ``size`` components, float64, starting at ``x0``."""

    def __init__(self, size: int = 1, theta: float = 0.15, mu: float = 0.0,
                 sigma: float = 0.3, dt: float = 1.0, x0: float | None = None,
                 sigma_min: float | None = None,
                 n_steps_annealing: int = 1000,
                 seed: int | None = None):
        super().__init__(mu=mu, sigma=sigma, sigma_min=sigma_min,
                         n_steps_annealing=n_steps_annealing)
        self.theta = theta
        self.dt = dt
        self.size = size
        self.x0 = x0 if x0 is not None else 0.0
        self.rng = np.random.default_rng(seed)
        self.reset_states()

    def reset_states(self) -> None:
        self.x_prev = np.full((self.size,), self.x0, dtype=np.float64)

    def sample(self) -> np.ndarray:
        x = (self.x_prev
             + self.theta * (self.mu - self.x_prev) * self.dt
             + self.current_sigma * np.sqrt(self.dt)
             * self.rng.standard_normal(self.size))
        self.x_prev = x
        self.n_steps += 1
        return x
