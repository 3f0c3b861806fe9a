"""Transition/batch schema — the port's copy of
pytorch_distributed_tpu/utils/experience.py.

An n-step transition is ``(s_t, a_t, R_t, gamma_n, s_{t+m}, terminal_{t+m})``
with ``R_t = sum_{k<m} gamma^k r_{t+k}`` and ``gamma_n = gamma^m``; the
learner target is ``R_t + gamma_n * bootstrap(s_{t+m}) * (1 - terminal)``.
A ``Transition`` carries the reference's optional provenance sidecar
(:44-96): ``prov``, a (4,) int64 vector ``(actor_id, env_slot,
param_version, birth_step)`` minted at action time, or None.  Rings keep
it in a column of their own beside the six replay columns: iterate
``REPLAY_FIELDS``, not ``Transition._fields``, for the six.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

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
    prov: Optional[np.ndarray] = None  # (4,) int64 provenance, or None


# the provenance vector's layout (``make_prov``): who acted, from which
# env slot, under which published param version, and the learner step
# the actor saw (sample age is then a learner-step difference)
PROV_FIELDS = ("actor_id", "env_slot", "param_version", "birth_step")
PROV_DTYPE = np.int64
PROV_NONE = np.full(len(PROV_FIELDS), -1, dtype=PROV_DTYPE)


def make_prov(actor_id: int, env_slot: int, param_version: int,
              birth_step: int) -> np.ndarray:
    """One provenance vector, minted at action time."""
    return np.array([actor_id, env_slot, param_version, birth_step],
                    dtype=PROV_DTYPE)


def stack_prov(items) -> np.ndarray:
    """The provenance of ``[(Transition, priority), ...]`` or of bare
    Transitions as an (n, 4) int64 column; a row without provenance is
    ``(-1, -1, -1, -1)``."""
    rows = []
    for it in items:
        # a Transition is a tuple too: unwrap only plain (item, priority)
        # pairs, or it[0] would be the state array
        t = (it[0] if isinstance(it, tuple)
             and not hasattr(it, "_fields") else it)
        p = getattr(t, "prov", None)
        rows.append(PROV_NONE if p is None
                    else np.asarray(p, dtype=PROV_DTYPE))
    return (np.stack(rows) if rows
            else np.zeros((0, len(PROV_FIELDS)), dtype=PROV_DTYPE))


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
