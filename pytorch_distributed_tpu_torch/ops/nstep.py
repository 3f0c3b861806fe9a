"""n-step transition assembly — the port's copy of
pytorch_distributed_tpu/ops/nstep.py (``NStepAssembler``), bit-identical in
behaviour.

For each step t of an episode emit ``(s_t, a_t, R_t, gamma^m, s_{t+m},
term_{t+m})`` with ``m = min(nstep, T - t)``: windows shrink at the episode
tail instead of bootstrapping across the boundary.  The terminal flag is 1
iff the window reaches a true episode end (truncation still bootstraps).
"""

from __future__ import annotations

from collections import deque
from typing import List

import numpy as np

from pytorch_distributed_tpu_torch.utils.experience import Transition


class NStepAssembler:
    """Feed ``(s, a, r, s', terminal, truncated)`` once per env step; yields
    zero or more finished n-step ``Transition``s per feed."""

    def __init__(self, nstep: int, gamma: float):
        if nstep < 1:
            raise ValueError(f"nstep must be >= 1, got {nstep}")
        self.nstep = nstep
        self.gamma = gamma
        self._buf: deque = deque()  # open [s, a, r_sum, m, s_last] windows

    def feed(self, state0, action, reward, state1, terminal: bool,
             truncated: bool = False, prov=None) -> List[Transition]:
        """``prov`` is the provenance minted at this action
        (utils/experience.make_prov); it rides the window and is attached
        to the row the window emits."""
        self._buf.append([state0, action, 0.0, 0, state1, prov])
        for row in self._buf:  # this reward enters every open window
            row[2] += (self.gamma ** row[3]) * reward
            row[3] += 1
            row[4] = state1
        out: List[Transition] = []
        if terminal or truncated:
            true_terminal = terminal and not truncated
            while self._buf:
                out.append(self._emit(self._buf.popleft(), true_terminal))
        else:
            while self._buf and self._buf[0][3] >= self.nstep:
                out.append(self._emit(self._buf.popleft(), False))
        return out

    def _emit(self, row, terminal: bool) -> Transition:
        state0, action, r_sum, m, state1, prov = row
        return Transition(
            state0=np.asarray(state0),
            action=np.asarray(action),
            reward=np.float32(r_sum),
            gamma_n=np.float32(self.gamma ** m),
            state1=np.asarray(state1),
            terminal1=np.float32(1.0 if terminal else 0.0),
            prov=prov,
        )
