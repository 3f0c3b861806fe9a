"""N Pong games stepped as one batch by the C++ stepper — the port of
pytorch_distributed_tpu/envs/native_pong.py (``NativePongVectorEnv``).

A drop-in for ``envs.vector.VectorEnv`` over N ``PongSimEnv``: the same
observations (84x84 uint8, action repeat with a max-pool over the last two
raw frames, a ``state_cha``-frame stack), the same auto-reset (the reset
observation is returned and the true terminal one is in
``info["final_obs"]``, with ``info["truncated"]`` at ``early_stop``), and
the same seed slots (env j of actor i seeds ``seed + i*N + j``).  One C
call steps all N games; ``native/pong_batch.cpp`` is built by
``utils/native_build.py``.  The stepper draws ball serves from its own
generator, so its episodes are not the numpy simulator's; its dynamics
between serves are the same to the bit (``set_state``).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Any, Dict, List, Tuple

import numpy as np

from pytorch_distributed_tpu_torch.envs.base import DiscreteSpace
from pytorch_distributed_tpu_torch.utils.native_build import load_library

NUM_ACTIONS = 6

_lib = None
_lib_lock = threading.Lock()


def get_lib() -> ctypes.CDLL:
    """The stepper's library, built at first use; raises
    ``NativeBuildError`` if it cannot be built."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = load_library("pong_batch")
            lib.pong_create.restype = ctypes.c_void_p
            lib.pong_create.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64)]
            lib.pong_destroy.restype = None
            lib.pong_destroy.argtypes = [ctypes.c_void_p]
            lib.pong_reset.restype = None
            lib.pong_reset.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.pong_step.restype = None
            lib.pong_step.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 7
            lib.pong_state_size.restype = ctypes.c_int
            lib.pong_state_size.argtypes = []
            lib.pong_get_state.restype = None
            lib.pong_get_state.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_double)]
            lib.pong_set_state.restype = None
            lib.pong_set_state.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_double)]
            lib.pong_render.restype = None
            lib.pong_render.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_void_p]
            _lib = lib
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class NativePongVectorEnv:
    """N Pong games stepped as one batch in native code."""

    def __init__(self, env_params, process_ind: int, num_envs: int):
        self.params = env_params
        self.num_envs = num_envs
        self.hist = env_params.state_cha
        self.norm_val = 255.0
        self.training = True
        self._lib = get_lib()
        seeds = (ctypes.c_int64 * num_envs)(*[
            env_params.seed + process_ind * num_envs + j
            for j in range(num_envs)])
        self._h = self._lib.pong_create(
            num_envs, self.hist, env_params.action_repetition,
            env_params.early_stop or 0, seeds)
        if not self._h:
            raise RuntimeError("pong_create failed")
        n, h = num_envs, self.hist
        self._obs = np.empty((n, h, 84, 84), dtype=np.uint8)
        self._final = np.empty((n, h, 84, 84), dtype=np.uint8)
        self._rewards = np.empty(n, dtype=np.float32)
        self._terminals = np.empty(n, dtype=np.uint8)
        self._truncateds = np.empty(n, dtype=np.uint8)
        self._scores = np.empty((n, 2), dtype=np.int32)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.pong_destroy(h)
            self._h = None

    def train(self) -> None:
        self.training = True

    def eval(self) -> None:
        self.training = False

    @property
    def state_shape(self) -> Tuple[int, ...]:
        return (self.hist, 84, 84)

    @property
    def action_space(self) -> DiscreteSpace:
        return DiscreteSpace(NUM_ACTIONS)

    def reset(self) -> np.ndarray:
        self._lib.pong_reset(self._h, _ptr(self._obs))
        return self._obs.copy()

    def step(self, actions) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     List[Dict[str, Any]]]:
        acts = np.ascontiguousarray(np.asarray(actions, dtype=np.int32))
        if acts.shape != (self.num_envs,) or not (
                (acts >= 0) & (acts < NUM_ACTIONS)).all():
            raise ValueError(f"need {self.num_envs} actions in [0, "
                             f"{NUM_ACTIONS}), got {acts}")
        self._lib.pong_step(self._h, _ptr(acts), _ptr(self._obs),
                            _ptr(self._rewards), _ptr(self._terminals),
                            _ptr(self._truncateds), _ptr(self._final),
                            _ptr(self._scores))
        infos: List[Dict[str, Any]] = []
        for i in range(self.num_envs):
            info: Dict[str, Any] = {"score": tuple(self._scores[i])}
            if self._terminals[i]:
                info["final_obs"] = self._final[i].copy()
                if self._truncateds[i]:
                    info["truncated"] = True
            infos.append(info)
        return (self._obs.copy(), self._rewards.copy(),
                self._terminals.astype(bool), infos)

    # test hooks: env i's game state as 10 doubles: the dynamics (player_y,
    # enemy_y, ball x, y, vx, vy, the enemy's and the player's scores),
    # then the episode's step count and the generator's state

    def get_state(self, i: int) -> np.ndarray:
        buf = (ctypes.c_double * self._lib.pong_state_size())()
        self._lib.pong_get_state(self._h, i, buf)
        return np.asarray(buf, dtype=np.float64).copy()

    def set_state(self, i: int, state: np.ndarray) -> None:
        """Overwrite the leading entries of env i's state; a shorter vector
        keeps the rest (the episode clock and the generator)."""
        cur = self.get_state(i)
        cur[:len(state)] = np.asarray(state, dtype=np.float64)
        buf = (ctypes.c_double * len(cur))(*cur)
        self._lib.pong_set_state(self._h, i, buf)

    def render_frame(self, i: int) -> np.ndarray:
        frame = np.empty((84, 84), dtype=np.uint8)
        self._lib.pong_render(self._h, i, _ptr(frame))
        return frame
