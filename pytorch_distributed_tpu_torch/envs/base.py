"""Env abstraction — the port's copy of pytorch_distributed_tpu/envs/base.py
(rendering left out).

Mode switches as the reference's (:73-78, reference core/env.py:29-35):
``train()`` is the actors' mode, ``eval()`` restores the standard episode
boundaries for the evaluator and the tester.  Pong has no lives, so the
simulator steps the same in both.

``reset() -> obs`` / ``step(a) -> (obs, reward, terminal, info)``; n-step
assembly lives with the actor (ops/nstep.py).  ``process_ind`` is a global
env slot: actor i's env j passes slot i*N + j, and the env seeds its numpy
generator with ``seed + slot``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np


@dataclass(frozen=True)
class DiscreteSpace:
    n: int


class Env:
    """Base env.  Subclasses implement ``_reset``/``_step`` and set
    ``state_shape``, ``action_space``, ``norm_val``."""

    def __init__(self, env_params, process_ind: int = 0):
        self.params = env_params
        self.process_ind = process_ind
        self.seed = env_params.seed + process_ind
        self.rng = np.random.default_rng(self.seed)
        self.training = True
        self.norm_val: float = 1.0
        self._episode_steps = 0

    def train(self) -> None:
        self.training = True

    def eval(self) -> None:
        self.training = False

    def reset(self) -> np.ndarray:
        self._episode_steps = 0
        return self._reset()

    def step(self, action) -> Tuple[np.ndarray, float, bool, Dict[str, Any]]:
        obs, reward, terminal, info = self._step(action)
        self._episode_steps += 1
        if self.params.early_stop and \
                self._episode_steps >= self.params.early_stop:
            terminal = True
            info.setdefault("truncated", True)
        return obs, reward, terminal, info

    @property
    def state_shape(self) -> Tuple[int, ...]:
        raise NotImplementedError

    @property
    def action_space(self):
        raise NotImplementedError

    def _reset(self) -> np.ndarray:
        raise NotImplementedError

    def _step(self, action) -> Tuple[np.ndarray, float, bool, Dict[str, Any]]:
        raise NotImplementedError
