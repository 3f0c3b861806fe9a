"""Deterministic chain MDP for tests and smoke runs — the port's copy of
pytorch_distributed_tpu/envs/fake_env.py:19-67.

A chain of ``length`` states, observed one-hot (float32): action 1 moves
right, action 0 moves left (floor at state 0); reaching the right end is
terminal and pays +1, every other step 0.  The optimal policy always moves
right, and ``optimal_q`` gives its Q table in closed form.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from pytorch_distributed_tpu_torch.envs.base import DiscreteSpace, Env


class FakeChainEnv(Env):
    LENGTH = 8

    def __init__(self, env_params, process_ind: int = 0,
                 length: Optional[int] = None):
        super().__init__(env_params, process_ind)
        self.length = length or self.LENGTH
        self.pos = 0
        self.norm_val = 1.0

    @property
    def state_shape(self) -> Tuple[int, ...]:
        return (self.length,)

    @property
    def action_space(self) -> DiscreteSpace:
        return DiscreteSpace(2)

    def _obs(self) -> np.ndarray:
        o = np.zeros((self.length,), dtype=np.float32)
        o[self.pos] = 1.0
        return o

    def _reset(self) -> np.ndarray:
        self.pos = 0
        return self._obs()

    def _step(self, action) -> Tuple[np.ndarray, float, bool, Dict[str, Any]]:
        if int(action) == 1:
            self.pos += 1
        else:
            self.pos = max(0, self.pos - 1)
        terminal = self.pos >= self.length - 1
        return self._obs(), 1.0 if terminal else 0.0, terminal, {}

    def optimal_q(self, gamma: float) -> np.ndarray:
        """The optimal Q table, (length - 1, 2) over the non-terminal
        states: moving right from state i is worth gamma ** (L - 2 - i)."""
        L = self.length
        q = np.zeros((L - 1, 2), dtype=np.float64)
        v = lambda i: gamma ** (L - 2 - i) if i <= L - 2 else 0.0
        for i in range(L - 1):
            right = 1.0 if i + 1 == L - 1 else gamma * v(i + 1)
            left = gamma * v(max(0, i - 1))
            q[i] = [left, right]
        return q
