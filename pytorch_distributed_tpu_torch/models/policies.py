"""Action selection — the port of pytorch_distributed_tpu/models/policies.py:
``apex_epsilon(s)`` (:22-45), epsilon-greedy act (:48-70), the inference
server's packed acts (``_pack_dqn`` :100-108, ``build_packed_roll_act``
:140-165, ``build_packed_act_rowkeys`` :168-180), greedy act (:517), and
the fused device rollout (``RolloutCarry``/``RolloutChunk``/
``RolloutStats``, ``init_rollout_carry`` :190-274, ``build_fused_rollout``
:277-491, ``rollout_priorities`` :494-514).

The reference derives per-(tick, row) JAX keys on the device; those
streams cannot be replayed in torch, so the port's act takes its
randomness as arguments (explore uniforms and random actions, one per
row) and the caller draws them from its own ``torch.Generator``.  So a
row's action depends on that row's arguments alone, however rows were
batched together.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch.memory.device_replay import (
    ring_write_masked,
)
from pytorch_distributed_tpu_torch.utils.experience import Transition


def apex_epsilon(process_ind: int, num_actors: int,
                 eps: float = 0.4, eps_alpha: float = 7.0) -> float:
    """Ape-X per-actor schedule ``eps ** (1 + i/(N-1) * alpha)``, with the
    single-actor debug value 0.1."""
    if num_actors <= 1:
        return 0.1
    frac = process_ind / (num_actors - 1)
    return float(eps ** (1.0 + frac * eps_alpha))


def apex_epsilons(process_ind: int, num_actors: int, num_envs: int,
                  eps: float = 0.4, eps_alpha: float = 7.0) -> np.ndarray:
    """Per-env epsilons: env j of actor i takes fleet slot i*num_envs + j
    of num_actors*num_envs."""
    total = num_actors * num_envs
    return np.asarray(
        [apex_epsilon(process_ind * num_envs + j, total, eps, eps_alpha)
         for j in range(num_envs)], dtype=np.float32)


@torch.no_grad()
def epsilon_greedy_act(apply_fn: Callable, params, obs: torch.Tensor,
                       eps: torch.Tensor, explore_u: torch.Tensor,
                       random_a: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row i takes ``random_a[i]`` when ``explore_u[i] < eps[i]``, else its
    greedy action.  Returns ``(action, q_sel, q_max)``."""
    q = apply_fn(params, obs)
    action = torch.where(explore_u < eps, random_a, q.argmax(-1))
    q_sel = q.gather(1, action[:, None])[:, 0]
    return action, q_sel, q.max(-1).values


def pack_dqn(q: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """One (3, B) float32 tensor of (action, q_sel, q_max) rows, so a
    response costs one device-to-host copy (action indices are small
    integers, exact in fp32)."""
    q_sel = q.gather(1, action[:, None])[:, 0]
    return torch.stack([action.float(), q_sel.float(),
                        q.max(-1).values.float()])


@torch.no_grad()
def packed_act_rows(apply_fn: Callable, params, obs: torch.Tensor,
                    eps: torch.Tensor, explore_u: torch.Tensor,
                    random_a: torch.Tensor) -> torch.Tensor:
    """The epsilon-greedy act over rows of any origin, packed: the
    inference server's program for a full upload, one client's rows or
    several clients' concatenated, each row with its own ``eps``,
    ``explore_u`` and ``random_a``."""
    q = apply_fn(params, obs)
    action = torch.where(explore_u < eps, random_a, q.argmax(-1))
    return pack_dqn(q, action)


@torch.no_grad()
def packed_roll_act(apply_fn: Callable, params, stack: torch.Tensor,
                    new: torch.Tensor, eps: torch.Tensor,
                    explore_u: torch.Tensor, random_a: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The frame-packed act: roll the client's resident ``(B, C, H, W)``
    uint8 ``stack`` by its newest ``(B, H, W)`` frames, in place, then act
    on it.  Returns ``(stack, packed)``.  The client sends only the newest
    frames when the roll held on its side, so the rolled stack is what
    the env emitted."""
    stack.copy_(torch.cat([stack[:, 1:], new[:, None]], dim=1))
    return stack, packed_act_rows(apply_fn, params, stack, eps, explore_u,
                                  random_a)


@torch.no_grad()
def greedy_act(apply_fn: Callable, params, obs: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pure-greedy act, for evaluation: ``(action, q_max)``."""
    q = apply_fn(params, obs)
    return q.argmax(-1), q.max(-1).values


# ---------------------------------------------------------------------------
# The fused device rollout: env, policy and n-step assembly of K ticks as
# one program (one CUDA graph on the card)
# ---------------------------------------------------------------------------

_WINDOWS = ("win_action", "win_qsel", "win_racc", "win_age", "win_open",
            "win_term", "win_prio_ok", "win_close_slot", "win_qboot",
            "win_need_boot")


@dataclass
class RolloutCarry:
    """What the fused rollout keeps on the device between dispatches: the
    env fleet's state and the open n-step windows, updated in place by
    every dispatch (the reference donates its carry).

    The windows implement ``ops/nstep.py``'s assembler with fixed shapes:
    every env tick t opens one window (s_t, a_t) at slot ``t % R``; a
    window closes when it holds ``nstep`` rewards or the episode ends (a
    true terminal stamps ``terminal1``; truncation closes it but it still
    bootstraps), and is emitted ``nstep`` ticks after it opened, by which
    time it is closed and its bootstrap q_max (the next forward after its
    close) is stamped.  R = nstep + 1 keeps the emission slot (t - nstep)
    and the open slot (t) apart."""

    env_state: Any
    win_s0: torch.Tensor          # (N, R, *obs) uint8: s0 per window
    win_action: torch.Tensor      # (N, R) int64
    win_qsel: torch.Tensor        # (N, R) f32: q(s0, a) at open
    win_racc: torch.Tensor        # (N, R) f32: discounted reward sum
    win_age: torch.Tensor         # (N, R) int64: rewards accumulated
    win_open: torch.Tensor        # (N, R) bool
    win_term: torch.Tensor        # (N, R) f32: terminal1 at close
    win_prio_ok: torch.Tensor     # (N, R) bool: False for truncated closes
    win_close_slot: torch.Tensor  # (N, R) int64: obs_true slot at close
    win_qboot: torch.Tensor       # (N, R) f32: bootstrap q_max
    win_need_boot: torch.Tensor   # (N, R) bool: closed, awaiting a forward
    obs_true: torch.Tensor        # (N, R, *obs) uint8: true post-step obs
    tick: torch.Tensor            # () int64: the next tick, on the device
    ticks: int = 0                # the same, on the host


class RolloutChunk(NamedTuple):
    """A chunk-emit dispatch's output, ``(K, N)``-leading: the six replay
    columns, ``valid`` (False only for the run's first ``nstep`` ticks),
    the PER scalars (``prio_ok`` False marks truncated closes) and the
    per-tick env stats."""

    state0: Any
    action: Any
    reward: Any
    gamma_n: Any
    state1: Any
    terminal1: Any
    valid: Any
    q_sel: Any
    q_boot: Any
    prio_ok: Any
    step_reward: Any     # (K, N) f32 raw per-tick env rewards
    step_terminal: Any   # (K, N) bool
    step_truncated: Any  # (K, N) bool


class RolloutStats(NamedTuple):
    """A replay-emit dispatch's output: the per-tick env stats, ``fed``
    the rows written (on the device) and ``rows`` the same count known on
    the host (a pure function of the tick window)."""

    step_reward: Any
    step_terminal: Any
    step_truncated: Any
    fed: Any
    rows: int


def init_rollout_carry(env, nstep: int) -> RolloutCarry:
    """A fresh carry on the env's device: env at reset, no open window."""
    n, R = env.num_envs, nstep + 1
    dev = env.device
    obs = tuple(env.state_shape)
    z = lambda dt: torch.zeros((n, R), dtype=dt, device=dev)
    return RolloutCarry(
        env_state=env.init(),
        win_s0=torch.zeros((n, R, *obs), dtype=torch.uint8, device=dev),
        win_action=z(torch.int64), win_qsel=z(torch.float32),
        win_racc=z(torch.float32), win_age=z(torch.int64),
        win_open=z(torch.bool), win_term=z(torch.float32),
        win_prio_ok=z(torch.bool), win_close_slot=z(torch.int64),
        win_qboot=z(torch.float32), win_need_boot=z(torch.bool),
        obs_true=torch.zeros((n, R, *obs), dtype=torch.uint8, device=dev),
        tick=torch.zeros((), dtype=torch.int64, device=dev))


def _copy_into(dst, src) -> None:
    """Copy ``src``'s tensors into ``dst``'s, field by field (NamedTuples
    or dicts); a field that is already the same tensor is skipped."""
    items = dst.items() if isinstance(dst, dict) else zip(dst._fields, dst)
    for k, d in items:
        s_ = src[k] if isinstance(src, dict) else getattr(src, k)
        if s_ is not d:
            d.copy_(s_)


class FusedRollout:
    """N envs x K ticks of policy forward, epsilon-greedy action, env step
    and n-step assembly as one program over a ``RolloutCarry`` updated in
    place: ``rollout(params, carry)``.  ``build_fused_rollout`` makes it.

    Randomness is the caller's: ``draw(gen)`` fills ``explore_u`` and
    ``random_a`` (K, N) from its generator tick by tick, as the inline
    actor draws each tick (``rand(N)``, then ``randint(A, (N,))``); tests
    may write them directly.  So a rollout over an env equals the inline
    actor over that env's vector wrapper, and two rollouts at one seed
    equal each other whatever they emit.

    ``emit="chunk"`` returns a ``RolloutChunk`` of (K, N) columns for the
    host to feed; ``emit="replay"`` writes the valid rows into ``ring``
    (a ``ReplayState``; ``ring_write_fn``, by default the uniform
    ``ring_write_masked``) at its device cursor, set from ``ring.pos``
    before the dispatch, advances the ring's host ``pos``/``fill`` by the
    rows the tick window holds, and returns ``RolloutStats``.

    On a CUDA device (unless ``graph=False``) the first two calls run
    eagerly, then one dispatch is captured into a CUDA graph on a side
    stream (``thread_local``, so other threads go on launching) and every
    call replays it on the current stream: the tick, the ring slots and
    the ring cursor are device tensors, so one graph serves every
    dispatch.  ``params`` are copied into the graph's
    static weights before each replay unless they are those tensors.  A
    capture that fails raises; there is no eager fallback on the card.
    The outputs of a graphed call are its static buffers, overwritten by
    the next call."""

    def __init__(self, apply_fn: Callable, env, *, nstep: int, gamma: float,
                 rollout_ticks: int, eps, emit: str = "chunk", ring=None,
                 ring_write_fn: Optional[Callable] = None,
                 graph: Optional[bool] = None):
        if emit not in ("chunk", "replay"):
            raise ValueError(f"unknown emit {emit!r}")
        if emit == "replay" and ring is None:
            raise ValueError("emit='replay' writes into a ring: pass ring")
        self.apply_fn, self.env, self.emit = apply_fn, env, emit
        self.nstep, self.K = nstep, int(rollout_ticks)
        self.N, self.R = env.num_envs, nstep + 1
        self.device = dev = torch.device(env.device)
        self.ring = ring
        if ring is not None:
            self.capacity = ring.reward.shape[0]
            if self.N > self.capacity:
                raise ValueError(f"{self.N} envs for a ring of "
                                 f"{self.capacity} rows")
            self._write = ring_write_fn or ring_write_masked
        # discount powers computed in float64 and cast once, as the host
        # assembler sums in float64 and casts at emit
        self.gamma_pow = torch.as_tensor(
            np.power(np.float64(gamma), np.arange(self.R)).astype(
                np.float32), device=dev)
        self.eps = torch.as_tensor(np.asarray(eps, np.float32), device=dev)
        self.explore_u = torch.zeros((self.K, self.N), device=dev)
        self.random_a = torch.zeros((self.K, self.N), dtype=torch.int64,
                                    device=dev)
        self._rows = torch.arange(self.N, device=dev)
        self._graphed = dev.type == "cuda" if graph is None else graph
        self._warmup = 2  # eager calls before the capture
        self._graph = None
        self._params = None
        self._out = None

    # -- randomness and accounting -------------------------------------

    def draw(self, gen: torch.Generator) -> None:
        """This dispatch's explore uniforms and random actions from
        ``gen``, tick by tick, in the inline actor's order."""
        na = self.env.num_actions
        for k in range(self.K):
            self.explore_u[k].copy_(torch.rand(self.N, generator=gen,
                                               device=gen.device))
            self.random_a[k].copy_(torch.randint(
                na, (self.N,), generator=gen, device=gen.device))

    def rows_in_window(self, t0: int) -> int:
        """Rows the dispatch from tick ``t0`` emits: N for every tick past
        the ``nstep`` warmup."""
        return self.N * max(0, self.K - max(0, self.nstep - t0))

    # -- the program -----------------------------------------------------

    def _tick(self, params, c: RolloutCarry, env_state, w: dict, t, k: int):
        """One tick; ``w`` holds the small window arrays (replaced), the
        frame rings of ``c`` are written in place."""
        nstep = self.nstep
        obs = self.env.observe(env_state)
        q = self.apply_fn(params, obs)
        qmax = q.max(-1).values.float()
        # windows closed at t-1 take this forward's q_max, the forward the
        # host actor's pending queue resolves them against
        qboot = torch.where(w["win_need_boot"], qmax[:, None],
                            w["win_qboot"])
        action = torch.where(self.explore_u[k] < self.eps,
                             self.random_a[k], q.argmax(-1))
        q_sel = q.gather(1, action[:, None])[:, 0].float()
        env_state, out = self.env.step(env_state, action)
        slot = (t % self.R).reshape(1)
        col = lambda a, v: a.index_copy(1, slot, v[:, None])
        zeros_f = torch.zeros_like(q_sel)
        # open this tick's window at ``slot``
        c.win_s0.index_copy_(1, slot, obs[:, None])
        win_action = col(w["win_action"], action)
        win_qsel = col(w["win_qsel"], q_sel)
        win_racc = col(w["win_racc"], zeros_f)
        win_age = col(w["win_age"], torch.zeros_like(action))
        win_open = col(w["win_open"], torch.ones_like(out.terminal))
        # this tick's reward into every open window
        win_racc = win_racc + torch.where(
            win_open, self.gamma_pow[win_age] * out.reward[:, None], 0.0)
        win_age = win_age + win_open.to(torch.int64)
        c.obs_true.index_copy_(1, slot, out.final_obs[:, None])
        term, trunc = out.terminal, out.truncated
        true_term = (term & ~trunc).float()
        # closes: a full window, or the episode's end (truncation too)
        closing = win_open & ((win_age >= nstep) | term[:, None])
        win_open = win_open & ~closing
        w = dict(
            win_action=win_action, win_qsel=win_qsel, win_racc=win_racc,
            win_age=win_age, win_open=win_open,
            win_term=torch.where(closing, true_term[:, None],
                                 w["win_term"]),
            win_prio_ok=torch.where(closing, (~trunc)[:, None],
                                    w["win_prio_ok"]),
            win_close_slot=torch.where(closing, slot, w["win_close_slot"]),
            win_qboot=qboot,
            win_need_boot=closing & (true_term == 0.0)[:, None])
        # emission: the window opened nstep ticks ago
        slot_e = ((t - nstep) % self.R).reshape(1)
        get = lambda a: a.index_select(1, slot_e)[:, 0]
        term1_e = get(w["win_term"])
        emitted = dict(
            state0=get(c.win_s0), action=get(win_action),
            reward=get(win_racc), gamma_n=self.gamma_pow[get(win_age)],
            state1=c.obs_true[self._rows, get(w["win_close_slot"])],
            terminal1=term1_e,
            valid=(t >= nstep).expand(self.N),
            q_sel=get(win_qsel),
            # true terminals never bootstrap
            q_boot=torch.where(term1_e > 0, 0.0, get(qboot)),
            prio_ok=get(w["win_prio_ok"]))
        return env_state, w, emitted, (out.reward, term, trunc)

    @torch.no_grad()
    def _program(self, params, c: RolloutCarry):
        """K ticks, then the carry written back in place; returns the
        stacked (K, N) outputs."""
        env_state = c.env_state
        w = {f: getattr(c, f) for f in _WINDOWS}
        cols: dict = {}
        fed = torch.zeros((), dtype=torch.int64, device=self.device)
        for k in range(self.K):
            t = c.tick + k
            env_state, w, em, stats = self._tick(params, c, env_state, w,
                                                 t, k)
            if self.emit == "replay":
                fed = fed + self._write(
                    self.ring, Transition(*(em[f] for f in
                                            Transition._fields)),
                    em["valid"], self.capacity)
                em = {}
            for name, v in zip(("step_reward", "step_terminal",
                                "step_truncated"), stats):
                em[name] = v
            for name, v in em.items():
                cols.setdefault(name, []).append(v)
        _copy_into(c.env_state, env_state)
        _copy_into({f: getattr(c, f) for f in _WINDOWS}, w)
        c.tick.add_(self.K)
        out = {k: torch.stack(v) for k, v in cols.items()}
        if self.emit == "replay":
            out["fed"] = fed
        return out

    def _capture(self, params, carry: RolloutCarry) -> None:
        self._params = {k: v.detach().clone() for k, v in params.items()}
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            # a side stream of its own, never the process's shared capture
            # stream; thread_local, so other threads go on launching
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self._out = self._program(self._params, carry)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(self.device).wait_stream(side)
        self._graph = graph

    def _eager_on_side_stream(self, params, carry):
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self._program(params, carry)
        cur.wait_stream(side)
        side.synchronize()
        return out

    def _dispatch(self, params, carry: RolloutCarry) -> dict:
        if not self._graphed:
            return self._program(params, carry)
        if self._graph is None and self._warmup > 0:
            # lazy set-up (cuDNN plans) must not happen under capture
            self._warmup -= 1
            return self._eager_on_side_stream(params, carry)
        if self._graph is None:
            self._capture(params, carry)
        elif params is not self._params:
            _copy_into(self._params, params)
        self._graph.replay()
        return self._out

    def __call__(self, params, carry: RolloutCarry):
        ring = self.ring
        if ring is not None:
            ring.cursor.fill_(ring.pos)
            if getattr(ring, "fill_rows", None) is not None:
                ring.fill_rows.fill_(float(ring.fill))
        out = self._dispatch(params, carry)
        t0 = carry.ticks
        carry.ticks += self.K
        if self.emit == "chunk":
            return RolloutChunk(**out)
        rows = self.rows_in_window(t0)
        ring.pos = (ring.pos + rows) % self.capacity
        ring.fill = min(ring.fill + rows, self.capacity)
        return RolloutStats(rows=rows, **out)


def build_fused_rollout(apply_fn: Callable, env, *, nstep: int,
                        gamma: float, rollout_ticks: int, eps,
                        emit: str = "chunk", ring=None,
                        ring_write_fn: Optional[Callable] = None,
                        **kw) -> FusedRollout:
    """The fused rollout of ``env`` under ``apply_fn`` (see
    ``FusedRollout``); ``eps`` is the per-env epsilon vector."""
    return FusedRollout(apply_fn, env, nstep=nstep, gamma=gamma,
                        rollout_ticks=rollout_ticks, eps=eps, emit=emit,
                        ring=ring, ring_write_fn=ring_write_fn, **kw)


def rollout_priorities(chunk_np: dict, enabled: bool):
    """Actor-side PER priorities off a fetched chunk's columns,
    ``|R + gamma_n * maxQ(s_end) * (1 - terminal1) - q_sel|`` in float64
    as the host actor computes them; ``prio_ok`` False rows (truncated
    closes) get None, the host path's new-sample max.  Returns an object
    array of float-or-None, or None when ``enabled`` is False."""
    if not enabled:
        return None
    f8 = lambda k: np.asarray(chunk_np[k], np.float64)
    pr = np.abs(f8("reward") + f8("gamma_n") * (1.0 - f8("terminal1"))
                * f8("q_boot") - f8("q_sel"))
    out = np.empty(pr.shape, dtype=object)
    ok = np.asarray(chunk_np["prio_ok"], bool)
    out[ok] = pr[ok].astype(np.float64)
    out[~ok] = None
    return out
