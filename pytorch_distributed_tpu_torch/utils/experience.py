"""Transition/batch schema — the port's copy of
pytorch_distributed_tpu/utils/experience.py.

An n-step transition is ``(s_t, a_t, R_t, gamma_n, s_{t+m}, terminal_{t+m})``
with ``R_t = sum_{k<m} gamma^k r_{t+k}`` and ``gamma_n = gamma^m``; the
learner target is ``R_t + gamma_n * bootstrap(s_{t+m}) * (1 - terminal)``.
The provenance sidecar of the reference is not carried in this slice.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np

# the six replay columns, in ring/wire order
REPLAY_FIELDS = ("state0", "action", "reward", "gamma_n", "state1",
                 "terminal1")


class Transition(NamedTuple):
    """One n-step replay row (host numpy arrays)."""

    state0: np.ndarray     # (*state_shape,) uint8
    action: np.ndarray     # () int32
    reward: np.ndarray     # () float32 — discounted n-step reward sum
    gamma_n: np.ndarray    # () float32 — gamma**m bootstrap discount
    state1: np.ndarray     # (*state_shape,)
    terminal1: np.ndarray  # () float32 in {0, 1}


def transition_dtypes(state_dtype, action_dtype) -> dict:
    """Per-field storage dtypes of the six-array schema."""
    return dict(state0=state_dtype, action=action_dtype,
                reward=np.float32, gamma_n=np.float32,
                state1=state_dtype, terminal1=np.float32)


class Batch(NamedTuple):
    """A sampled minibatch (leading batch dim on every field) as tensors on
    the learner's device."""

    state0: Any
    action: Any
    reward: Any
    gamma_n: Any
    state1: Any
    terminal1: Any
    weight: Any   # importance-sampling weights (B,) float32
    index: Any    # ring slots (B,) int64, for priority write-back
