"""Pong as tensors on the acting device — the port of
pytorch_distributed_tpu/envs/device_env.py: the counter hash and
``CounterRng`` (:71-115), ``PongState``/``StepOut`` (:117-148),
``DeviceEnv`` (:150), ``_tick`` (:180-231), the render helpers
(:233-290), ``_reset_state`` (:291-331), ``make_device_pong``
(:333-424), the family gate and ``build_device_env`` (:426-472) and
``DevicePongVectorEnv`` (:474-531).

The whole fleet steps as one batch of elementwise tensor operations, with
auto-reset inside the step and the true post-step stack beside the reset
one (``final_obs``), the contract of ``envs/vector.py``.  The code is
written once over an operations table (``ops``): ``TorchOps`` runs it on
the device of its tensors (the CPU or the card), ``NumpyOps`` on the host
in float32 or float64, the parity oracle the tests and ``chip_smoke.py``
hold the torch step against.  For the float32 runs to agree to the bit
the step keeps the reference's operation order (``(0.5*(by-py))/5.0``),
uses no fused multiply-add (``addcmul``, ``lerp``, ``alpha=``), and
divides by a tensor, never by a Python number: on a CUDA tensor torch
turns a division by a host scalar into a product with its reciprocal.

Randomness is a counter hash of ``(slot_seed, draw_index)`` (splitmix32)
that numpy and torch evaluate alike: the uint32 arithmetic runs in int64
with every product taken mod 2**32 from 16-bit halves (no overflow) and
the result masked to 32 bits.  A step hashes every count it may draw at
once (two a point, at most one point a frame, and three for the
auto-reset) and reads the ones its envs use, so the hash costs one batch
of kernels a step, not one a draw.  Env j of actor i takes slot
``seed + i*N + j``, the host vector's slot contract.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch.envs.base import DiscreteSpace
from pytorch_distributed_tpu_torch.envs.pong_sim import (
    BALL_SPEED_X, ENEMY_SPEED, WIN_SCORE,
)

# ---------------------------------------------------------------------------
# the counter hash: a pure function of (slot_seed, draw_index)
# ---------------------------------------------------------------------------

_MIX1 = 0x7FEB352D
_MIX2 = 0x846CA68B
_SEED_GOLD = 0x9E3779B9  # Weyl constant decorrelating adjacent slot seeds
_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32): ``c`` split in
    16-bit halves keeps every product below 2**49."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def counter_mix(seed, count):
    """splitmix32-style avalanche of ``seed ^ (count * golden)`` with
    uint32 wraparound, on int64 numpy arrays or torch tensors (or Python
    ints); inputs are taken mod 2**32, the result lies in [0, 2**32)."""
    x = (seed & _M32) ^ _mul32(count & _M32, _SEED_GOLD)
    x = _mul32(x ^ (x >> 16), _MIX1)
    x = _mul32(x ^ (x >> 15), _MIX2)
    return x ^ (x >> 16)


# ---------------------------------------------------------------------------
# the operations table: torch on a device, or numpy on the host
# ---------------------------------------------------------------------------

class NumpyOps:
    """The step's operations in numpy, physics in ``dtype`` (float32, or
    float64 for the oracle leg against the host ``PongSimEnv``)."""

    def __init__(self, dtype=np.float32):
        self.dtype = self.np_dtype = np.dtype(dtype)
        self._f = self.dtype.type

    def c(self, v):
        """A physics constant in the physics type."""
        return self._f(v)

    def div(self, x, v):
        return x / self._f(v)

    def float_(self, x):
        return np.asarray(x).astype(self.dtype)

    def int_(self, x):
        return np.asarray(x).astype(np.int64)

    def u8(self, x):
        return np.asarray(x).astype(np.uint8)

    def ints(self, values):
        return np.asarray(values, dtype=np.int64)

    def zeros(self, n: int, kind: str):
        return np.zeros((n,), {"f": self.dtype, "i": np.int64}[kind])

    def full(self, n: int, v):
        return np.full((n,), self._f(v))

    def arange(self, n: int):
        return np.arange(n)

    @staticmethod
    def take(u, col):
        """Row i's column ``col[i]`` of a 2-D array."""
        return np.take_along_axis(u, col[:, None], 1)[:, 0]

    clip = staticmethod(np.clip)
    where = staticmethod(np.where)
    abs = staticmethod(np.abs)
    round = staticmethod(np.round)
    maximum = staticmethod(np.maximum)

    @staticmethod
    def cat(xs, axis: int):
        return np.concatenate(xs, axis=axis)

    @staticmethod
    def stack(xs, axis: int):
        return np.stack(xs, axis=axis)

    @staticmethod
    def repeat_frame(first, hist: int):
        n = first.shape[0]
        return np.broadcast_to(first[:, None], (n, hist, 84, 84)).copy()


class TorchOps:
    """The step's operations in torch float32 on ``device``."""

    dtype = torch.float32
    np_dtype = np.dtype(np.float32)

    def __init__(self, device="cpu"):
        self.device = torch.device(device)

    def c(self, v):
        # a Python float holding the float32 value: torch casts it to the
        # tensor's float32, exactly
        return float(np.float32(v))

    def div(self, x, v):
        return x / torch.full((), self.c(v), dtype=self.dtype,
                              device=x.device)

    def float_(self, x):
        return x.to(self.dtype)

    def int_(self, x):
        return x.to(torch.int64)

    def u8(self, x):
        return x.to(torch.uint8)

    def ints(self, values):
        return torch.as_tensor(np.asarray(values, dtype=np.int64),
                               device=self.device)

    def zeros(self, n: int, kind: str):
        return torch.zeros((n,), dtype={"f": self.dtype,
                                        "i": torch.int64}[kind],
                           device=self.device)

    def full(self, n: int, v):
        return torch.full((n,), self.c(v), dtype=self.dtype,
                          device=self.device)

    def arange(self, n: int):
        return torch.arange(n, device=self.device)

    @staticmethod
    def take(u, col):
        return torch.gather(u, 1, col[:, None])[:, 0]

    @staticmethod
    def clip(x, lo, hi):
        return torch.clamp(x, lo, hi)

    where = staticmethod(torch.where)
    abs = staticmethod(torch.abs)
    round = staticmethod(torch.round)

    @staticmethod
    def maximum(a, b):
        if isinstance(b, torch.Tensor):
            return torch.maximum(a, b)
        return torch.clamp(a, min=b)

    @staticmethod
    def cat(xs, axis: int):
        return torch.cat(xs, dim=axis)

    @staticmethod
    def stack(xs, axis: int):
        return torch.stack(xs, dim=axis)

    @staticmethod
    def repeat_frame(first, hist: int):
        return first[:, None].expand(-1, hist, -1, -1).contiguous()


def _unit(seed, count, ops):
    """``u`` in [0, 1) from the top 24 hash bits (exact in float32, so the
    float32 and float64 runs see the same ``u``)."""
    return ops.float_(counter_mix(seed, count) >> 8) * ops.c(1.0 / (1 << 24))


def _affine(u, lo: float, hi: float, ops):
    f = ops.np_dtype.type
    return ops.c(lo) + ops.c(f(hi) - f(lo)) * u


def counter_uniform(seed, count, lo: float, hi: float, ops):
    """``lo + (hi - lo) * u`` in the physics type, ``u`` from ``_unit``."""
    return _affine(_unit(seed, count, ops), lo, hi, ops)


class CounterRng:
    """The numpy-Generator surface ``PongSimEnv`` draws from (``uniform``,
    ``random``) over the device env's counter stream, in float64: patched
    into a ``PongSimEnv`` it walks the episode the device env walks."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self.count = 0
        self._ops = NumpyOps(np.float64)

    def uniform(self, lo: float, hi: float) -> float:
        self.count += 1
        return float(counter_uniform(np.int64(self.seed),
                                     np.int64(self.count), lo, hi,
                                     self._ops))

    def random(self) -> float:
        return self.uniform(0.0, 1.0)


# ---------------------------------------------------------------------------
# the protocol
# ---------------------------------------------------------------------------

class PongState(NamedTuple):
    """Batched per-env state (leading dim N everywhere)."""

    player_y: Any
    enemy_y: Any
    ball_x: Any
    ball_y: Any
    ball_vx: Any
    ball_vy: Any
    score_enemy: Any     # (N,) int64
    score_player: Any    # (N,) int64
    episode_steps: Any   # (N,) int64
    rng_count: Any       # (N,) int64 draw counter, < 2**32
    seed: Any            # (N,) int64 slot seed (constant)
    stack: Any           # (N, hist, 84, 84) uint8 current obs


class StepOut(NamedTuple):
    """One batched env step: ``obs`` after auto-reset, ``final_obs`` the
    true post-step stack (the terminal frames where ``terminal``)."""

    obs: Any           # (N, hist, 84, 84) uint8
    final_obs: Any     # (N, hist, 84, 84) uint8
    reward: Any        # (N,) float32
    terminal: Any      # (N,) bool
    truncated: Any     # (N,) bool
    score: Any         # (N, 2) int64 (enemy, player)


@dataclass(frozen=True)
class DeviceEnv:
    """An env family as three functions over a batched state:
    ``init()`` the reset state of all N envs, ``step(state, actions) ->
    (state', StepOut)`` (auto-reset inside; new tensors, the inputs are
    not written), ``observe(state)`` the current observation.  ``step``
    has fixed shapes, no host synchronisation and no data-dependent
    control flow, so a CUDA graph can capture it."""

    num_envs: int
    state_shape: Tuple[int, ...]
    num_actions: int
    norm_val: float
    init: Callable[[], Any]
    step: Callable[[Any, Any], Tuple[Any, StepOut]]
    observe: Callable[[Any], Any]
    device: Any = None


# ---------------------------------------------------------------------------
# Pong, transcribed from envs/pong_sim.py.  Every float constant is the
# evaluated form of the pong_sim expression it mirrors (PADDLE_H/2 = 5.0,
# H - PADDLE_H/2 = 79.0, BALL/2 = 1.0, 2*(H - BALL/2) = 166.0,
# PLAYER_X - PADDLE_W = 76.0, ENEMY_X + PADDLE_W = 6.0).
# ---------------------------------------------------------------------------

class _Consts(NamedTuple):
    """The render's constants, made once per env: the row coordinates, the
    paddles' column masks and the reset frame's paddle base."""

    ys: Any     # (1, 84) physics type
    ecol: Any   # (1, 84) uint8
    pcol: Any   # (1, 84) uint8
    base: Any   # (1, 84, 84) uint8: both paddles at 42.0


def _consts(ops) -> _Consts:
    ys = ops.float_(ops.arange(84))[None, :]
    cols = ops.arange(84)
    ecol = ops.u8((cols >= 2) & (cols < 4))[None, :]
    pcol = ops.u8((cols >= 78) & (cols < 80))[None, :]
    center = ops.full(1, 42.0)
    k = _Consts(ys, ecol, pcol, None)
    return k._replace(base=_paddles(_row_band(center, 5.0, 130, ys, ops),
                                    _row_band(center, 5.0, 150, ys, ops),
                                    k, ops))


def _draws(s: PongState, units, c0, i: int, ops):
    """Unit draw ``i`` past each env's counter: the hash of count
    ``rng_count + 1 + i``, read from ``units`` (the step's draws of counts
    ``c0 + 1`` on)."""
    return ops.take(units, s.rng_count - c0 + i)


def _tick(s: PongState, move, units, c0, ops):
    """One raw emulator frame (pong_sim.PongSimEnv._tick).  A point draws
    the next serve's ball y and vy at counts ``rng_count + 1, + 2``."""
    c = ops.c
    py = ops.clip(s.player_y + move, c(5.0), c(79.0))
    err = s.ball_y - s.enemy_y
    ey = ops.clip(s.enemy_y + ops.clip(err, c(-ENEMY_SPEED), c(ENEMY_SPEED)),
                  c(5.0), c(79.0))
    bx = s.ball_x + s.ball_vx
    by = s.ball_y + s.ball_vy
    bvy = s.ball_vy
    lo = by < c(1.0)
    hi = by > c(83.0)
    by = ops.where(lo, c(2.0) - by, ops.where(hi, c(166.0) - by, by))
    bvy = ops.where(lo | hi, -bvy, bvy)
    bvx = s.ball_vx
    # paddle collisions: conditions from the pre-collision bvx/bx (the
    # host's if/elif, exclusive because they need opposite bvx signs)
    hitp = (bvx > 0) & (bx >= c(76.0)) & (ops.abs(by - py) <= c(6.0))
    hite = (~hitp) & (bvx < 0) & (bx <= c(6.0)) \
        & (ops.abs(by - ey) <= c(6.0))
    english_p = ops.clip(bvy + ops.div(c(0.5) * (by - py), 5.0),
                         c(-2.0), c(2.0))
    english_e = ops.clip(bvy + ops.div(c(0.5) * (by - ey), 5.0),
                         c(-2.0), c(2.0))
    bvy = ops.where(hitp, english_p, ops.where(hite, english_e, bvy))
    bx = ops.where(hitp, c(76.0), ops.where(hite, c(6.0), bx))
    bvx = ops.where(hitp | hite, -bvx, bvx)
    # scoring (the host's two early-return ifs; exclusive by bx's sign)
    p_scores = bx < c(0.0)           # player point, serve direction -1
    e_scores = bx > c(84.0)          # enemy point, serve direction +1
    scored = p_scores | e_scores
    reward = ops.where(p_scores, c(1.0),
                       ops.where(e_scores, c(-1.0), c(0.0)))
    direction = ops.where(p_scores, c(-1.0), c(1.0))
    new_by = _affine(_draws(s, units, c0, 0, ops), 20.0, 64.0, ops)
    new_bvy = _affine(_draws(s, units, c0, 1, ops), -1.2, 1.2, ops)
    bx = ops.where(scored, c(42.0), bx)
    by = ops.where(scored, new_by, by)
    bvx = ops.where(scored, c(BALL_SPEED_X) * direction, bvx)
    bvy = ops.where(scored, new_bvy, bvy)
    count = s.rng_count + 2 * ops.int_(scored)
    return s._replace(
        player_y=py, enemy_y=ey, ball_x=bx, ball_y=by, ball_vx=bvx,
        ball_vy=bvy, score_enemy=s.score_enemy + ops.int_(e_scores),
        score_player=s.score_player + ops.int_(p_scores),
        rng_count=count), reward


def _row_band(center, half: float, value: int, ys, ops):
    """(N, 84) uint8 row band [round(c-half), round(c+half)) at ``value``
    — the vspan slice of pong_sim._draw as a mask."""
    lo = ops.round(center - ops.c(half))[:, None]
    hi = ops.round(center + ops.c(half))[:, None]
    return ops.u8((ys >= lo) & (ys < hi)) * value


def _ball_overlay(ball_x, ball_y, ys, ops):
    br = ops.u8((ys >= ops.round(ball_y)[:, None] - 1)
                & (ys < ops.round(ball_y)[:, None] + 1))
    bc = ops.u8((ys >= ops.round(ball_x)[:, None] - 1)
                & (ys < ops.round(ball_x)[:, None] + 1))
    return br[:, :, None] * (bc * 236)[:, None, :]


def _paddles(er, pr, k: _Consts, ops):
    return ops.maximum(er[:, :, None] * k.ecol[:, None, :],
                       pr[:, :, None] * k.pcol[:, None, :])


def _render(s: PongState, k: _Consts, ops):
    """(N, 84, 84) uint8 frame == pong_sim._draw.  The host draws
    background (35), enemy (130), player (150), ball (236) in overwrite
    order; the values increase, so overwrite == pixelwise max."""
    frame = _paddles(_row_band(s.enemy_y, 5.0, 130, k.ys, ops),
                     _row_band(s.player_y, 5.0, 150, k.ys, ops), k, ops)
    return ops.maximum(
        ops.maximum(frame, _ball_overlay(s.ball_x, s.ball_y, k.ys, ops)), 35)


def _render_union(s2: PongState, s3: PongState, k: _Consts, ops):
    """max(render(s2), render(s3)) in one pass — the action-repeat
    max-pool as a render over unioned masks (exact: each frame is a
    pixelwise max of its contributions)."""
    ys = k.ys
    er = ops.maximum(_row_band(s2.enemy_y, 5.0, 130, ys, ops),
                     _row_band(s3.enemy_y, 5.0, 130, ys, ops))
    pr = ops.maximum(_row_band(s2.player_y, 5.0, 150, ys, ops),
                     _row_band(s3.player_y, 5.0, 150, ys, ops))
    frame = _paddles(er, pr, k, ops)
    ball = ops.maximum(_ball_overlay(s2.ball_x, s2.ball_y, ys, ops),
                       _ball_overlay(s3.ball_x, s3.ball_y, ys, ops))
    return ops.maximum(ops.maximum(frame, ball), 35)


def _reset_state(seed, count, u3, n: int, hist: int, k: _Consts,
                 ops) -> PongState:
    """Fresh-episode state for all N envs (pong_sim._reset): centered
    paddles, serve direction from one draw, ball y/vy from two more.
    ``count`` is each env's draw counter before the reset draws and
    ``u3`` those three unit draws (counts ``count + 1 .. + 3``).  The
    stack holds the first frame ``hist`` times: the paddle base shared
    by every env under each env's ball overlay, bit-equal to
    ``_render``."""
    c = ops.c
    direction = ops.where(_affine(u3[0], 0.0, 1.0, ops) < c(0.5),
                          c(1.0), c(-1.0))
    ball_y = _affine(u3[1], 20.0, 64.0, ops)
    ball_x = ops.full(n, 42.0)
    first = ops.maximum(
        ops.maximum(k.base, _ball_overlay(ball_x, ball_y, k.ys, ops)), 35)
    return PongState(
        player_y=ops.full(n, 42.0), enemy_y=ops.full(n, 42.0),
        ball_x=ball_x, ball_y=ball_y,
        ball_vx=c(BALL_SPEED_X) * direction,
        ball_vy=_affine(u3[2], -1.2, 1.2, ops),
        score_enemy=ops.zeros(n, "i"), score_player=ops.zeros(n, "i"),
        episode_steps=ops.zeros(n, "i"), rng_count=count + 3, seed=seed,
        stack=ops.repeat_frame(first, hist))


def make_device_pong(env_params, slot_seeds, ops=None) -> DeviceEnv:
    """The Pong ``DeviceEnv`` of the given slot seeds.  ``ops``:
    ``TorchOps(device)`` (default: the CPU) or ``NumpyOps(dtype)``, the
    oracle."""
    ops = ops if ops is not None else TorchOps()
    n = len(slot_seeds)
    hist = int(env_params.state_cha)
    rep = int(env_params.action_repetition)
    early_stop = int(env_params.early_stop or 0)
    seeds = [int(s) for s in slot_seeds]
    k = _consts(ops)
    # counts a step may draw, past its first counter: two a point (at most
    # one a frame) and three for the auto-reset; hashed at once
    n_draws = 2 * rep + 3
    offsets = ops.ints(np.arange(1, n_draws + 1))[None, :]

    def init() -> PongState:
        seed, count = ops.ints(seeds), ops.zeros(n, "i")
        u = _unit(seed[:, None], count[:, None] + offsets[:, :3], ops)
        return _reset_state(seed, count, (u[:, 0], u[:, 1], u[:, 2]), n,
                            hist, k, ops)

    def observe(state: PongState):
        return state.stack

    def step(state: PongState, actions):
        c = ops.c
        a = actions
        move = ops.where((a == 2) | (a == 4), c(-2.0),
                         ops.where((a == 3) | (a == 5), c(2.0), c(0.0)))
        reward = ops.zeros(n, "f")
        c0 = state.rng_count
        units = _unit(state.seed[:, None], c0[:, None] + offsets, ops)
        s = state
        states = []
        for _k in range(rep):
            s, r = _tick(s, move, units, c0, ops)
            reward = reward + r
            states.append(s)
        if rep >= 2:
            frame = _render_union(states[rep - 2], states[rep - 1], k, ops)
        else:
            frame = _render(s, k, ops)
        true_stack = ops.cat([state.stack[:, 1:], frame[:, None]], 1)
        steps = s.episode_steps + 1
        game_over = ops.maximum(s.score_enemy, s.score_player) >= WIN_SCORE
        # no early_stop: never truncated (steps are never negative)
        truncated = (steps >= early_stop) if early_stop else (steps < 0)
        terminal = game_over | truncated
        score = ops.stack([s.score_enemy, s.score_player], 1)
        # auto-reset: a terminal env's obs is the fresh episode's first
        # stack; the true terminal stack rides final_obs
        fresh = _reset_state(
            s.seed, s.rng_count,
            tuple(_draws(s, units, c0, i, ops) for i in range(3)), n, hist,
            k, ops)
        s = s._replace(episode_steps=steps, stack=true_stack)

        def sel(new, old):
            t = terminal.reshape(terminal.shape + (1,) * (old.ndim - 1))
            return ops.where(t, new, old)

        nxt = PongState(*(sel(f_new, f_old)
                          for f_new, f_old in zip(fresh, s)))
        nxt = nxt._replace(seed=state.seed)
        return nxt, StepOut(obs=nxt.stack, final_obs=true_stack,
                            reward=reward, terminal=terminal,
                            truncated=truncated, score=score)

    return DeviceEnv(num_envs=n, state_shape=(hist, 84, 84), num_actions=6,
                     norm_val=255.0, init=init, step=step, observe=observe,
                     device=getattr(ops, "device", None))


# ---------------------------------------------------------------------------
# factory surface
# ---------------------------------------------------------------------------

# device env families and the env_type each re-implements: the two must
# agree (a Pong fleet behind another game's learner would train on the
# wrong env)
DEVICE_ENV_FAMILIES: Dict[str, Callable] = {"pong": make_device_pong}
_ENV_TYPE_FAMILY: Dict[str, str] = {"pong-sim": "pong"}


def resolve_device_env_family(env_params):
    """The device family of this env config, or None when its env_type
    has none.  An explicit ``device_env_family`` must name the env_type's
    own family; it never substitutes another game."""
    fam = _ENV_TYPE_FAMILY.get(env_params.env_type)
    explicit = getattr(env_params, "device_env_family", "auto") or "auto"
    if explicit == "auto":
        return fam
    if explicit != fam:
        raise ValueError(
            f"device_env_family={explicit!r} does not implement "
            f"env_type={env_params.env_type!r} (its device family is "
            f"{fam!r}; families: {sorted(DEVICE_ENV_FAMILIES)})")
    return fam


def device_env_supported(env_params) -> bool:
    """Whether this env config has a device implementation."""
    return resolve_device_env_family(env_params) is not None


def build_device_env(env_params, process_ind: int, num_envs: int,
                     ops=None) -> DeviceEnv:
    """The device env of one actor slot: env j of actor i takes slot
    ``seed + i*N + j``."""
    fam = resolve_device_env_family(env_params)
    if fam is None:
        raise ValueError(
            f"no device env implementation for env_type="
            f"{env_params.env_type!r} (families: "
            f"{sorted(DEVICE_ENV_FAMILIES)})")
    return DEVICE_ENV_FAMILIES[fam](
        env_params, [env_params.seed + process_ind * num_envs + j
                     for j in range(num_envs)], ops=ops)


# ---------------------------------------------------------------------------
# host-facing wrapper (a VectorEnv drop-in)
# ---------------------------------------------------------------------------

class DevicePongVectorEnv:
    """The ``VectorEnv`` surface (reset/step with ``final_obs`` and
    ``truncated`` infos) over the device step on ``device``, so the
    host-loop actors can run the device env."""

    def __init__(self, env_params, process_ind: int, num_envs: int,
                 device="cpu"):
        self.params = env_params
        self.num_envs = num_envs
        self.norm_val = 255.0
        self.training = True
        self.device = torch.device(device)
        self._env = build_device_env(env_params, process_ind, num_envs,
                                     ops=TorchOps(self.device))
        self._state = None

    def train(self) -> None:
        self.training = True

    def eval(self) -> None:
        self.training = False

    @property
    def state_shape(self) -> Tuple[int, ...]:
        return self._env.state_shape

    @property
    def action_space(self) -> DiscreteSpace:
        return DiscreteSpace(self._env.num_actions)

    def reset(self) -> np.ndarray:
        self._state = self._env.init()
        return self._env.observe(self._state).cpu().numpy()

    def step(self, actions) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     List[Dict[str, Any]]]:
        acts = torch.as_tensor(np.asarray(actions, dtype=np.int64),
                               device=self.device)
        if tuple(acts.shape) != (self.num_envs,):
            raise ValueError(f"actions of shape {tuple(acts.shape)} for "
                             f"{self.num_envs} envs")
        self._state, out = self._env.step(self._state, acts)
        obs = out.obs.cpu().numpy()
        reward = out.reward.cpu().numpy()
        terminal = out.terminal.cpu().numpy()
        truncated = out.truncated.cpu().numpy()
        score = out.score.cpu().numpy()
        final = None
        infos: List[Dict[str, Any]] = []
        for j in range(self.num_envs):
            info: Dict[str, Any] = {
                "score": tuple(int(v) for v in score[j])}
            if terminal[j]:
                if final is None:
                    final = out.final_obs.cpu().numpy()
                info["final_obs"] = final[j]
                if truncated[j]:
                    info["truncated"] = True
            infos.append(info)
        return obs, reward, terminal, infos
