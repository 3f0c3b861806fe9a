"""The R2D2 actor — the port of pytorch_distributed_tpu/agents/
recurrent_actor.py (:1-181): the harness of agents/actor.py (env vector,
Ape-X epsilons, weight prefetch, stat and timer cadences, schedules) with
a policy that carries an LSTM state across ticks and experience that
leaves as overlapping episode segments (memory/sequence_replay.py
``SegmentBuilder``, one per env) in place of n-step transitions.

- The carry stored with a step is the one the policy held before acting
  on it, as the model's ``state_for_segment`` gives it: an LSTM's (c, h)
  row, the stored state the learner's burn-in starts from, or a
  transformer's 1-dim placeholder pair (its context is the segment
  window itself; reference :71-80).
- A time-limit truncation ends the segment but is not a death: the
  builder gets ``terminal`` False and ``episode_end`` True, so the learner
  bootstraps from the successor obs stored after the tail (reference
  :71-104).
- The carry (the model's ``zero_carry`` at the start: an LSTM pair, a
  DTQN's (window, filled) pair) lives on the acting device across ticks
  (no upload of it per tick); an episode's end reaches the next tick's
  act as a per-row reset mask (models/policies.py
  ``recurrent_packed_act``), which zeroes the rows before acting.  The
  host keeps a copy of each tick's post-act carry for the segments and
  zeroes its rows at the episode's end, so the host copy and the device
  carry agree at every episode boundary (reference :111-158).

Schedules: ``inline`` and ``pipelined``, as the flat families' (the next
tick's act is dispatched before this tick's segments are built; a
one-thread executor on the CPU, the actor's CUDA stream with pinned
staging and an event on a GPU).  ``batched`` steps down to ``pipelined``
with the reference's warning (an inference server holds no per-env
recurrent state), and so do ``device`` and ``anakin``
(factory.resolve_actor_backend).  Exploration draws (explore uniforms and
random actions) come from the actor's ``torch.Generator`` at each
dispatch, in tick order, so both schedules give the same segments.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pytorch_distributed_tpu_torch.agents.actor import DqnActor
from pytorch_distributed_tpu_torch.factory import (
    module_apply, sequence_pack_frames, state_dtype,
)
from pytorch_distributed_tpu_torch.memory.sequence_replay import (
    SegmentBuilder,
)
from pytorch_distributed_tpu_torch.models.policies import (
    recurrent_packed_act,
)
from pytorch_distributed_tpu_torch.utils.experience import make_prov


class _RecurrentEngine:
    """The tick's recurrent act as ``submit(params, obs)`` and
    ``collect(pending)``.  ``submit`` resets the rows of ``reset_next`` and
    advances the device carry; ``collect`` returns the actions and sets
    ``carry_before`` (the host copy the tick acted from) and
    ``carry_after`` (a new host copy of the post-act carry), which the
    actor's ``advance`` reads.  ``zero_carry`` is the model's carry for
    the actor's envs, each leaf a tensor with a row an env."""

    def __init__(self, apply_fn, eps: np.ndarray, gen: torch.Generator,
                 num_actions: int, zero_carry, obs_shape,
                 device: torch.device, stream, pipelined: bool,
                 obs_dtype=np.uint8):
        n = self._n = len(eps)
        self._apply, self._gen = apply_fn, gen
        self._num_actions = num_actions
        self._device, self._stream = device, stream
        self._eps = torch.as_tensor(eps, device=device)
        self._carry = tuple(c.to(device).clone() for c in zero_carry)
        self.reset_next = np.zeros(n, dtype=bool)
        self.carry_after = tuple(c.cpu().numpy().copy() for c in zero_carry)
        self.carry_before = self.carry_after
        self._pool = None
        if device.type == "cuda":
            pin = lambda shape, dt: torch.empty(shape, dtype=dt,
                                                pin_memory=True)
            self._obs = torch.from_numpy(
                np.empty((n, *obs_shape), dtype=obs_dtype)).pin_memory()
            self._u, self._a = pin(n, torch.float32), pin(n, torch.int64)
            self._mask = pin(n, torch.bool)
            self._actions = pin(n, torch.int64)
            self._host_carry = tuple(pin(c.shape, c.dtype)
                                     for c in zero_carry)
            self._done = torch.cuda.Event()
        elif pipelined:
            self._pool = ThreadPoolExecutor(1, thread_name_prefix="act")

    def _act(self, params, obs, mask, u, a):
        action, self._carry = recurrent_packed_act(
            self._apply, params, obs, self._carry, mask, self._eps, u, a)
        return action

    def _act_cpu(self, params, obs: np.ndarray, mask: np.ndarray, u, a):
        action = self._act(params, torch.from_numpy(obs),
                           torch.from_numpy(mask), u, a)
        return action.numpy(), tuple(c.numpy().copy() for c in self._carry)

    def submit(self, params, obs: np.ndarray):
        u = torch.rand(self._n, generator=self._gen)
        a = torch.randint(self._num_actions, (self._n,), generator=self._gen)
        mask, self.reset_next = self.reset_next, np.zeros(self._n, bool)
        if self._device.type == "cuda":
            self._obs.numpy()[...] = obs
            self._mask.numpy()[...] = mask
            self._u.copy_(u)
            self._a.copy_(a)
            dev = self._device
            with torch.cuda.stream(self._stream):
                action = self._act(
                    params, self._obs.to(dev, non_blocking=True),
                    self._mask.to(dev, non_blocking=True),
                    self._u.to(dev, non_blocking=True),
                    self._a.to(dev, non_blocking=True))
                self._actions.copy_(action, non_blocking=True)
                for host, c in zip(self._host_carry, self._carry):
                    host.copy_(c, non_blocking=True)
                self._done.record(self._stream)
            return self._done
        if self._pool is not None:
            return self._pool.submit(self._act_cpu, params, obs, mask, u, a)
        return self._act_cpu(params, obs, mask, u, a)

    def collect(self, pending) -> np.ndarray:
        if self._device.type == "cuda":
            pending.synchronize()
            actions = self._actions.numpy().copy()
            carry = tuple(c.numpy().copy() for c in self._host_carry)
        else:
            actions, carry = (pending.result() if self._pool is not None
                              else pending)
        self.carry_before, self.carry_after = self.carry_after, carry
        return actions.astype(np.int64)

    def discard(self, pending) -> None:
        """Wait for a dispatch whose actions are never used."""
        if self._device.type == "cuda":
            pending.synchronize()
        elif self._pool is not None:
            pending.result()

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)


class RecurrentActor(DqnActor):
    """The r2d2 actor: ``DqnActor``'s harness with the recurrent engine and
    a ``SegmentBuilder`` per env (see the module docstring)."""

    def __init__(self, opt, spec, process_ind, *args, **kwargs):
        super().__init__(opt, spec, process_ind, *args, **kwargs)
        ap = self.ap
        self.assemblers = None  # segments replace the n-step windows
        self.builders = [
            SegmentBuilder(ap.seq_len, ap.seq_overlap,
                           state_dtype=state_dtype(opt),
                           pack_frames=sequence_pack_frames(opt))
            for _ in range(self.num_envs)]

    def _local_engine(self, opt, spec, model, eps, gen, device, stream):
        self._state_for_segment = model.state_for_segment
        return _RecurrentEngine(
            module_apply(model), eps, gen, spec.num_actions,
            model.zero_carry(self.num_envs), spec.state_shape, device,
            stream,
            pipelined=self.backend == "pipelined",
            obs_dtype=state_dtype(opt))

    def note_step(self, terminals) -> None:
        # the next act zeroes these rows of the device carry first
        self.engine.reset_next = np.asarray(terminals, dtype=bool).copy()

    def advance(self, actions, next_obs, rewards, terminals, infos) -> None:
        before, after = self.engine.carry_before, self.engine.carry_after
        for j in range(self.num_envs):
            true_next = infos[j].get("final_obs", next_obs[j])
            truncated = bool(infos[j].get("truncated", False))
            for seg in self.builders[j].push(
                    self._obs[j], int(actions[j]), float(rewards[j]),
                    bool(terminals[j]) and not truncated, true_next,
                    self._state_for_segment(before, j),
                    episode_end=bool(terminals[j]),
                    prov=make_prov(self.process_ind, j, self._feed_version,
                                   self._birth_step)):
                self.memory.feed(seg)
            self.episode_steps[j] += 1
            self.episode_reward[j] += float(rewards[j])
            if terminals[j]:
                self._record_episode(j, infos[j])
                # the host copy's rows start the next episode at zero, as
                # the reset mask zeroes the device rows in the next act
                for c in after:
                    c[j] = 0
                self.builders[j].reset()
        self._obs = next_obs
        self._flush_cadence()
