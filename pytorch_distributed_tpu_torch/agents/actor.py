"""Actor workers: experience collection — the port of
pytorch_distributed_tpu/agents/actor.py: the harness (``_ActorHarness``
:120-390: ``tick_sync``, ``advance``, ``on_env_reset``, the stat and timer
cadences), the local act engines (``_LocalDqnEngine`` :415-437,
``_LocalDdpgEngine`` :453-475), the batched engines (``_BatchedDqnEngine``
:479-497, ``_BatchedDdpgEngine`` :500-516), DDPG's ``_ou_explore``
(:443-450), the loop (``_drive_actor_loop`` :524-590),
``fold_rollout_episode_stats`` (:592-614), the device loop
(``_drive_device_actor_loop`` :616-745), ``run_dqn_actor`` and
``run_ddpg_actor`` (:748-810, one ``run_actor`` here) and
``bounded_actor_run`` (:828).

Each actor steps ``num_envs_per_actor`` Pong games as one vector (the C++
stepper unless ``native_env`` is false), runs ONE batched forward per
tick, assembles n-step transitions per env and feeds them to the ingest
queue.  Exploration follows Ape-X over the whole fleet: env j of actor i
takes slot i*N + j.  The weights are the learner's newest published
vector (agents/param_store.py): a ``ParamPrefetcher`` thread fetches and
unflattens it, and every ``actor_sync_freq`` env steps the tick swaps in
what the thread finished.  Per-tick randomness (explore uniforms and
random actions) is drawn from the actor's own ``torch.Generator``, seeded
from ``--seed`` and the actor index, when the tick's forward is submitted,
in tick order; so every schedule and backend draws the same streams.

Where an actor infers: a child process of the process backend on the CPU,
as the reference pins every child there (runtime.py:53-70; its actors
call ``pin_to_cpu``, actor.py:425), so only the learner's process holds a
CUDA context.  A thread of the thread backend infers on the run's device;
on a GPU each runs on a high-priority CUDA stream of its own, so waiting
for its actions waits for its own forward and not for the learner's
queued updates.

Schedules (``actor_backend``):

- ``inline``: act(k) . env(k) . tick_sync . feed(k);
- ``pipelined`` (the default): act(k) was dispatched before feed(k-1);
  sync(k) . env(k) . tick_sync . dispatch act(k+1) . feed(k).  On the CPU
  the forward runs on a one-thread executor (torch's kernels and the
  stepper's C call both release the GIL, so the forward and the env step
  overlap); on a GPU it is enqueued on the actor's stream, its actions come
  back by a non-blocking copy into pinned memory, and an event marks the
  copy.

Both schedules submit and collect once per tick and swap weights at the
same point (after the env step, before the next dispatch), so their
transition streams are identical (tests/test_torch_actor_pipeline.py).

``batched`` runs the pipelined schedule with no model in the actor: its
engine sends each tick's observations, with the randomness drawn here as
above, to the shared inference server (agents/inference.py) and collects
the actions; the weights are the server's, so ``tick_sync`` swaps
nothing.  Its stream equals ``inline``'s on the same weights
(tests/test_torch_inference.py).

``device`` steps no host env: the actor's Pong fleet lives as tensors on
its device (envs/device_env.py) and one fused rollout
(models/policies.py) runs K = ``device_rollout_ticks`` ticks of forward,
action, env step and n-step assembly per dispatch; the host fetches the
chunk once and feeds its valid rows.  The weight swap, the stat flush,
the liveness mark and the ``ACTOR_FAULTS`` frame (one a tick on the other
backends) run once a dispatch.  Timer phases: ``rollout`` (the
dispatch), ``emit`` (the chunk's copy to the host), ``advance`` (feed and
episode accounting), ``param_swap``.  In a child of the process backend
the fleet runs on the CPU; a thread of the thread backend runs it on the
card as one CUDA graph on the actor's stream.  Its explore draws come
from the actor's generator in the inline order, so over the same env its
transitions are the inline actor's (tests/test_torch_fused_rollout.py).
An actor is never the co-located ``anakin`` loop (the learner is): an
actor slot under ``anakin`` runs ``device``.

DDPG actors (``DdpgActor``) run the same harness and schedules
(``inline``, ``pipelined``, ``batched``; ``device`` and ``anakin`` step
down to ``pipelined``, factory.resolve_actor_backend) with the policy's
deterministic forward in place of the epsilon-greedy one (on the server
under ``batched``), and add Ornstein-Uhlenbeck noise on the host when the
tick's actions are collected (``ou_explore``), clipped to [-1, 1]: one
process of ``num_envs * action_dim`` components (utils/random_process.py),
seeded as the reference seeds it (``ou_seed``), its sigma annealed over
``memory_size * 100`` samples, each env's slice reset to ``x0`` when its
episode ends.  Collection is in tick order on every schedule, so the
noise stream, and with it the transition stream, is the same on all
three (tests/test_torch_ddpg_actor.py).

The R2D2 actor (agents/recurrent_actor.py ``RecurrentActor``) runs the
same harness and the ``inline`` and ``pipelined`` schedules with a
recurrent engine whose carry stays on the acting device, and feeds
episode segments; the run loop hands it each tick's terminals
(``note_step``) for its next act's per-row reset.

Every row an actor feeds carries its provenance (reference :159-170,
:275, :734): ``make_prov(actor index, env slot, param version,
birth_step)``, the version that chose the tick's actions and the learner
step the actor saw at the tick's sync point (on ``device``, once a
dispatch: the rows of a dispatch share its stamp).  The actor's tracer
(utils/tracing.py, role ``actor``) records the feeder's ``enqueue`` spans
and is flushed into ``scalars.jsonl`` on the stat cadence and at the end
(reference :224-226, :312, :391); the feeder takes the run's flow policy
(``configure_flow``, reference :153-157).

The perf plane (utils/perf.py, reference :195-219, :242, :309-310,
:386-389, :551, :655-699): each actor's monitor (``actor-i``, tags
``actor/...``) counts its env frames, anchored at start-up and drained
on the stat cadence and at the end (``actor/env_frames_per_s`` and the
memory rows).  The device backend also counts the FLOPs of a frame
(``factory.frame_flops``), watches its rollout's graph for recaptures and
with ``transfer_audit`` runs each dispatch under ``TransferAudit``.
"""

from __future__ import annotations

import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Optional

import numpy as np
import torch

from pytorch_distributed_tpu_torch.agents.clocks import ActorStats, GlobalClock
from pytorch_distributed_tpu_torch.agents.param_store import (
    ParamPrefetcher, ParamStore, make_flattener,
)
from pytorch_distributed_tpu_torch.config import Options
from pytorch_distributed_tpu_torch.factory import (
    EnvSpec, build_device_env, build_env_vector, build_model, compute_dtype,
    frame_flops, init_params, module_apply, probe_env, resolve_actor_backend,
    resolve_device, role_seed, state_dtype,
)
from pytorch_distributed_tpu_torch.models.policies import (
    RolloutChunk, apex_epsilons, build_fused_rollout, ddpg_act,
    epsilon_greedy_act, init_rollout_carry,
)
from pytorch_distributed_tpu_torch.ops.nstep import NStepAssembler
from pytorch_distributed_tpu_torch.utils import perf, tracing
from pytorch_distributed_tpu_torch.utils.experience import (
    Transition, make_prov,
)
from pytorch_distributed_tpu_torch.utils.faults import FaultInjector
from pytorch_distributed_tpu_torch.utils.metrics import MetricsWriter
from pytorch_distributed_tpu_torch.utils.profiling import StepTimer
from pytorch_distributed_tpu_torch.utils.random_process import (
    OrnsteinUhlenbeckProcess,
)

class _DqnEngine:
    """The tick's fused epsilon-greedy forward as ``submit(params, obs)``,
    which dispatches it and draws the tick's randomness, and
    ``collect(pending)``, which returns the actions as a new numpy array.
    One engine serves both schedules."""

    def __init__(self, apply_fn, eps: np.ndarray, gen: torch.Generator,
                 num_actions: int, obs_shape, device: torch.device, stream,
                 pipelined: bool, obs_dtype=np.uint8):
        n = len(eps)
        self._apply = apply_fn
        self._gen = gen
        self._n, self._num_actions = n, num_actions
        self._eps = torch.as_tensor(eps, device=device)
        self._device, self._stream = device, stream
        self._pool = None
        if device.type == "cuda":
            # pinned staging both ways: the copies are enqueued on the
            # actor's stream and the host waits only in collect.  One set
            # suffices: collect(k) has waited for tick k's copies before
            # submit(k+1) refills them
            self._obs = torch.from_numpy(
                np.empty((n, *obs_shape), dtype=obs_dtype)).pin_memory()
            self._u = torch.empty(n, pin_memory=True)
            self._a = torch.empty(n, dtype=torch.int64, pin_memory=True)
            self._actions = torch.empty(n, dtype=torch.int64,
                                        pin_memory=True)
            self._done = torch.cuda.Event()
        elif pipelined:
            self._pool = ThreadPoolExecutor(1, thread_name_prefix="act")

    def _act_cpu(self, params, obs: np.ndarray, u, a) -> np.ndarray:
        action, _q_sel, _q_max = epsilon_greedy_act(
            self._apply, params, torch.from_numpy(obs), self._eps, u, a)
        return action.numpy()

    def submit(self, params, obs: np.ndarray):
        u = torch.rand(self._n, generator=self._gen)
        a = torch.randint(self._num_actions, (self._n,), generator=self._gen)
        if self._device.type == "cuda":
            self._obs.numpy()[...] = obs
            self._u.copy_(u)
            self._a.copy_(a)
            dev = self._device
            with torch.cuda.stream(self._stream):
                action, _q_sel, _q_max = epsilon_greedy_act(
                    self._apply, params,
                    self._obs.to(dev, non_blocking=True), self._eps,
                    self._u.to(dev, non_blocking=True),
                    self._a.to(dev, non_blocking=True))
                self._actions.copy_(action, non_blocking=True)
                self._done.record(self._stream)
            return self._done
        if self._pool is not None:
            return self._pool.submit(self._act_cpu, params, obs, u, a)
        return self._act_cpu(params, obs, u, a)

    def collect(self, pending) -> np.ndarray:
        if self._device.type == "cuda":
            pending.synchronize()
            return self._actions.numpy().copy()
        if self._pool is not None:
            return pending.result()
        return pending

    def discard(self, pending) -> None:
        """Wait for a dispatch whose actions are never used."""
        self.collect(pending)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)


class _BatchedDqnEngine:
    """The engine interface over an ``InferenceClient``: ``submit`` draws
    the tick's randomness exactly as ``_DqnEngine.submit`` does and sends
    the request; ``collect`` unpacks the actions from the response."""

    def __init__(self, client, eps: np.ndarray, gen: torch.Generator,
                 num_actions: int):
        self._client = client
        self._gen = gen
        self._n, self._num_actions = len(eps), num_actions
        self._tick = 0
        client.begin_session(eps)

    def submit(self, params, obs: np.ndarray):
        u = torch.rand(self._n, generator=self._gen)
        a = torch.randint(self._num_actions, (self._n,), generator=self._gen)
        self._tick += 1
        return self._client.submit(obs, self._tick, u.numpy(), a.numpy())

    def collect(self, pending) -> np.ndarray:
        return self._client.collect(pending)[0].astype(np.int64)

    def discard(self, pending) -> None:
        self._client.collect(pending)

    def close(self) -> None:
        pass


def ou_seed(seed: int, process_ind: int) -> int:
    """The OU process's seed of actor ``process_ind``: the reference's
    ``process_seed(seed, "actor", i) + 17`` (utils/rngs.py:32,
    agents/actor.py:808), so both packages draw the same noise."""
    return (seed + 1_000_000 + process_ind) % (2 ** 31 - 1) + 17


def ou_explore(ou: OrnsteinUhlenbeckProcess, actions: np.ndarray
               ) -> np.ndarray:
    """The policy's (N, d) actions plus one OU sample, clipped to [-1, 1]:
    one function for the local and the batched engines, whose noise
    streams must stay the same."""
    noise = ou.sample().reshape(actions.shape)
    return np.clip(actions + noise, -1.0, 1.0).astype(np.float32)


class _DdpgEngine:
    """The tick's deterministic policy forward as ``submit(params, obs)``
    and ``collect(pending)``, as ``_DqnEngine``'s (pinned staging and an
    event on a GPU, a one-thread executor when pipelined on the CPU);
    ``collect`` adds the noise."""

    def __init__(self, actor_fn, noise, n: int, action_dim: int, obs_shape,
                 device: torch.device, stream, pipelined: bool):
        self._apply, self._noise = actor_fn, noise
        self._device, self._stream = device, stream
        self._pool = None
        if device.type == "cuda":
            self._obs = torch.empty((n, *obs_shape), pin_memory=True)
            self._actions = torch.empty((n, action_dim), pin_memory=True)
            self._done = torch.cuda.Event()
        elif pipelined:
            self._pool = ThreadPoolExecutor(1, thread_name_prefix="act")

    def _act_cpu(self, params, obs: np.ndarray) -> np.ndarray:
        return ddpg_act(self._apply, params,
                        torch.from_numpy(np.asarray(obs, np.float32))
                        ).numpy()

    def submit(self, params, obs: np.ndarray):
        if self._device.type == "cuda":
            self._obs.numpy()[...] = obs
            with torch.cuda.stream(self._stream):
                a = ddpg_act(self._apply, params,
                             self._obs.to(self._device, non_blocking=True))
                self._actions.copy_(a, non_blocking=True)
                self._done.record(self._stream)
            return self._done
        if self._pool is not None:
            return self._pool.submit(self._act_cpu, params, obs)
        return self._act_cpu(params, obs)

    def _wait(self, pending) -> np.ndarray:
        if self._device.type == "cuda":
            pending.synchronize()
            return self._actions.numpy()
        if self._pool is not None:
            return pending.result()
        return pending

    def collect(self, pending) -> np.ndarray:
        return self._noise(self._wait(pending))

    def discard(self, pending) -> None:
        """Wait for a dispatch whose actions are never used; the noise
        process draws nothing for it, as the reference's loop, which
        never collects it."""
        self._wait(pending)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)


class _BatchedDdpgEngine:
    """The engine interface over an ``InferenceClient`` for DDPG: the
    server returns the policy's actions, ``collect`` adds the noise."""

    def __init__(self, client, noise):
        self._client, self._noise = client, noise
        self._tick = 0
        client.begin_session(None)

    def submit(self, params, obs: np.ndarray):
        self._tick += 1
        return self._client.submit(obs, self._tick)

    def collect(self, pending) -> np.ndarray:
        return self._noise(self._client.collect(pending))

    def discard(self, pending) -> None:
        self._client.collect(pending)

    def close(self) -> None:
        pass


class DqnActor:
    """One actor's state: its env vector, assemblers, weights, stat and
    timer cadences (reference ``_ActorHarness``); the dqn family's
    engines.  ``DdpgActor`` swaps the engines."""

    def __init__(self, opt: Options, spec: EnvSpec, process_ind: int,
                 memory: Any, param_store: ParamStore, clock: GlobalClock,
                 stats: ActorStats, inference: Any = None):
        self.backend = resolve_actor_backend(opt, inference)
        if self.backend == "anakin":
            # the co-located loop is the learner; an actor slot runs the
            # split-process device schedule over the same fleet
            self.backend = "device"
        self.ap = opt.agent_params
        self.memory, self.clock, self.stats = memory, clock, stats
        # the hang watchdog's liveness mark, once a tick (reference :244),
        # and the ACTOR_FAULTS plane, one frame a tick (reference :208,
        # :245): hang@N and crash@N drill the watchdog and the restarts
        self._label = f"actor-{process_ind}"
        self._bump = getattr(clock, "bump_progress", lambda label: None)
        self._faults = FaultInjector.from_env("actor")
        device = resolve_device(opt)
        n = self.num_envs = max(1, opt.env_params.num_envs_per_actor)
        if self.backend == "device":
            self.env = None
            self.device_env = build_device_env(opt, process_ind, n, device)
        else:
            self.env = build_env_vector(opt, process_ind, n)
        eps = apex_epsilons(process_ind, opt.num_actors, n, self.ap.eps,
                            self.ap.eps_alpha)
        # the device loop draws on its acting device; the host loops draw
        # on the CPU whatever device they infer on
        gen = torch.Generator(
            device=device if self.backend == "device" else "cpu"
        ).manual_seed(role_seed(opt.seed, "actor", process_ind))
        memory.set_stop(clock.stop)
        if hasattr(memory, "configure_flow"):
            memory.configure_flow(opt.flow_params)
        self.tracer = tracing.get_tracer("actor")
        if hasattr(memory, "set_tracer"):
            memory.set_tracer(self.tracer)
        self.process_ind = process_ind
        self._prefetch: Optional[ParamPrefetcher] = None
        if self.backend == "batched":
            # no model here: the server holds the weights.  The wait stays
            # as the barrier every worker starts behind (the learner is up)
            self.params = None
            _flat, self.version = param_store.wait(0, stop=clock.stop)
            self.engine = self._batched_engine(inference, eps, gen, spec)
        else:
            self._init_local(opt, spec, device, param_store, clock, eps,
                             gen)
        self.assemblers = [NStepAssembler(self.ap.nstep, self.ap.gamma)
                           for _ in range(n)]
        self.episode_reward = np.zeros(n)
        self.episode_steps = np.zeros(n, dtype=np.int64)
        self._acc = dict.fromkeys(ActorStats.FIELDS, 0.0)
        self.env_steps = 0
        self._next_sync = self.ap.actor_sync_freq
        self._next_flush = self.ap.actor_freq
        self.timer = StepTimer("actor")
        self._writer = MetricsWriter(opt.log_dir, enable_tensorboard=False,
                                     role=f"actor-{process_ind}",
                                     run_id=opt.refs)
        self.perf = perf.get_monitor(f"actor-{process_ind}", opt.perf_params,
                                     prefix="actor")
        self.perf.set_compute_dtype(compute_dtype(opt))
        if self.backend == "device" and self.perf.enabled:
            self.perf.register_jit("device_rollout",
                                   lambda: self.rollout.captures)
            self.perf.capture_frame_flops(lambda: frame_flops(opt, spec),
                                          frames_per_call=1)
        self.perf.drain()  # the first rate window starts here
        self._obs: Optional[np.ndarray] = None
        # the provenance stamp of the tick's rows: the version that acts
        # this tick and the learner step seen at its sync point
        self._feed_version = getattr(self, "version", 0)
        self._birth_step = int(clock.learner_step.value)

    def _init_local(self, opt, spec, device, param_store, clock, eps,
                    gen) -> None:
        """The model, the first weights, the prefetcher and the engine of
        an actor that infers itself (``inline``, ``pipelined``)."""
        # the module gives the forward its structure; the weights are
        # always the published vector's
        model = build_model(opt, spec, init_weights=False)
        _flat0, unflatten = make_flattener(model.state_dict(),
                                           spec.state_shape)
        stream = (torch.cuda.Stream(device, priority=-1)
                  if device.type == "cuda" else None)

        def load(flat):
            if device.type == "cpu":
                return unflatten(flat)
            return {k: v.pin_memory().to(device, non_blocking=True)
                    for k, v in unflatten(flat).items()}

        flat, self.version = param_store.wait(0, stop=clock.stop)
        with torch.cuda.stream(stream):  # a no-op for None
            self.params = load(flat)
        if stream is not None:
            stream.synchronize()
        self._prefetch = ParamPrefetcher(param_store, load,
                                         start_version=self.version,
                                         stream=stream)
        if self.backend == "device":
            self._stream, self._gen = stream, gen
            self.engine = None
            self.rollout = build_fused_rollout(
                module_apply(model), self.device_env, nstep=self.ap.nstep,
                gamma=self.ap.gamma,
                rollout_ticks=max(1, opt.env_params.device_rollout_ticks),
                eps=eps)
            return
        self.engine = self._local_engine(opt, spec, model, eps, gen, device,
                                         stream)

    def _batched_engine(self, inference, eps, gen, spec):
        return _BatchedDqnEngine(inference, eps, gen, spec.num_actions)

    def _local_engine(self, opt, spec, model, eps, gen, device, stream):
        return _DqnEngine(
            module_apply(model), eps, gen, spec.num_actions,
            spec.state_shape, device, stream,
            pipelined=self.backend == "pipelined",
            obs_dtype=state_dtype(opt))

    def on_env_reset(self, j: int) -> None:
        """Per-env exploration state to reset when env ``j``'s episode
        ends (DDPG's OU path); none for the dqn family."""

    def note_step(self, terminals) -> None:
        """After each env step, before the next dispatch: the tick's
        terminals, which a recurrent engine's next act resets its carry
        rows on; nothing for the flat families."""

    def tick_sync(self) -> None:
        """Once per tick, after the env step and before the next dispatch:
        count the steps and, on the sync cadence, swap in the prefetched
        weights (timed as ``param_swap``)."""
        n = self.num_envs
        self.env_steps += n
        # before the swap: the swap tick's rows carry the acting version
        self._feed_version = getattr(self, "version", 0)
        self._birth_step = int(self.clock.learner_step.value)
        self.perf.note_frames(n)
        self.clock.add_actor_steps(n)
        self._bump(self._label)
        self._faults.data_frame(())
        self._acc["total_nframes"] += n
        if self._prefetch is not None and self.env_steps >= self._next_sync:
            self._next_sync += self.ap.actor_sync_freq
            t0 = time.perf_counter()
            got = self._prefetch.take()
            if got is not None:
                self.params, self.version = got
                self.timer.add("param_swap", time.perf_counter() - t0)

    def advance(self, actions, next_obs, rewards, terminals, infos) -> None:
        """Feed the assemblers and the ingest queue with one tick, and run
        the stat and timer cadence."""
        for j in range(self.num_envs):
            true_next = infos[j].get("final_obs", next_obs[j])
            for t in self.assemblers[j].feed(
                    self._obs[j], actions[j], float(rewards[j]), true_next,
                    bool(terminals[j]),
                    truncated=bool(infos[j].get("truncated", False)),
                    prov=make_prov(self.process_ind, j, self._feed_version,
                                   self._birth_step)):
                self.memory.feed(t)
            self.episode_reward[j] += float(rewards[j])
            self.episode_steps[j] += 1
            if terminals[j]:
                self._record_episode(j, infos[j])
        self._obs = next_obs
        self._flush_cadence()

    def _record_episode(self, j: int, info: dict) -> None:
        """Env ``j``'s episode ended: its stats into the accumulators
        (reference actor.py:292-299), its counters and exploration state
        reset."""
        self._acc["nepisodes"] += 1
        self._acc["nepisodes_solved"] += float(bool(info.get(
            "solved", self.episode_reward[j] > 0)))
        self._acc["total_steps"] += float(self.episode_steps[j])
        self._acc["total_reward"] += self.episode_reward[j]
        self.episode_reward[j] = 0.0
        self.episode_steps[j] = 0
        self.on_env_reset(j)

    def _flush_cadence(self) -> None:
        if self.env_steps >= self._next_flush:
            self._next_flush += self.ap.actor_freq
            self._flush_stats()
            self._flush_rows(self.clock.learner_step.value)
            self.memory.flush()

    def _flush_stats(self) -> None:
        if any(self._acc.values()):
            self.stats.add(**self._acc)
            self._acc = dict.fromkeys(ActorStats.FIELDS, 0.0)

    def run(self) -> int:
        """Collect experience until the clock ends the run (reference
        ``_drive_actor_loop``).  The serial loop books ``act``; the
        pipelined loop books ``dispatch`` and ``sync``, and their sum as
        ``act``.  Returns the env steps taken."""
        if self.backend == "device":
            return self._run_device()
        timer, engine = self.timer, self.engine
        pipelined = self.backend in ("pipelined", "batched")
        self._obs = self.env.reset()
        try:
            pending = None
            if pipelined:
                t0 = time.perf_counter()
                pending = engine.submit(self.params, self._obs)
                timer.add("dispatch", time.perf_counter() - t0)
            t_sync = 0.0
            while not self.clock.done(self.ap.steps):
                t0 = time.perf_counter()
                if pipelined:
                    actions = engine.collect(pending)
                    t_sync = time.perf_counter() - t0
                    timer.add("sync", t_sync)
                else:
                    actions = engine.collect(engine.submit(self.params,
                                                           self._obs))
                    timer.add("act", time.perf_counter() - t0)
                with timer.phase("env"):
                    next_obs, rewards, terminals, infos = \
                        self.env.step(actions)
                self.note_step(terminals)
                self.tick_sync()
                if pipelined:
                    t0 = time.perf_counter()
                    pending = engine.submit(self.params, next_obs)
                    t_disp = time.perf_counter() - t0
                    timer.add("dispatch", t_disp)
                    timer.add("act", t_sync + t_disp)
                with timer.phase("advance"):
                    self.advance(actions, next_obs, rewards, terminals,
                                 infos)
            if pipelined:  # the last dispatch is never fed
                engine.discard(pending)
        finally:
            self.shutdown()
        return self.env_steps

    def _run_device(self) -> int:
        """The device loop (reference ``_drive_device_actor_loop``): per
        dispatch the rollout's K ticks on the device, one copy of the
        chunk to the host, then the cadences and the feed."""
        timer, ap, rollout = self.timer, self.ap, self.rollout
        frames = rollout.K * self.num_envs
        try:
            with torch.cuda.stream(self._stream):  # a no-op for None
                carry = init_rollout_carry(self.device_env, ap.nstep)
                while not self.clock.done(ap.steps):
                    t0 = time.perf_counter()
                    rollout.draw(self._gen)
                    if self.perf.audit is not None:
                        chunk = self.perf.audit.run(rollout, self.params,
                                                    carry)
                    else:
                        chunk = rollout(self.params, carry)
                    t1 = time.perf_counter()
                    ch = {f: getattr(chunk, f).cpu().numpy()
                          for f in RolloutChunk._fields}
                    t2 = time.perf_counter()
                    timer.add("rollout", t1 - t0)
                    timer.add("emit", t2 - t1)
                    # the dispatch's stamp: the version that acted in it,
                    # the learner step seen at its fetch
                    self._feed_version = self.version
                    self._birth_step = int(self.clock.learner_step.value)
                    self.env_steps += frames
                    self.perf.note_frames(frames)
                    self.clock.add_actor_steps(frames)
                    self._bump(self._label)
                    self._faults.data_frame(())  # one frame a dispatch
                    self._acc["total_nframes"] += frames
                    if self.env_steps >= self._next_sync:
                        self._next_sync += ap.actor_sync_freq
                        t0 = time.perf_counter()
                        got = self._prefetch.take()
                        if got is not None:
                            self.params, self.version = got
                            timer.add("param_swap", time.perf_counter() - t0)
                    with timer.phase("advance"):
                        self._feed_chunk(ch)
                        fold_rollout_episode_stats(
                            ch["step_reward"], ch["step_terminal"],
                            self.episode_reward, self.episode_steps,
                            self._acc)
                    if self.env_steps >= self._next_flush:
                        self._next_flush += ap.actor_freq
                        self._flush_stats()
                        self._flush_rows(self.clock.learner_step.value)
                        self.memory.flush()
        finally:
            self.shutdown()
        return self.env_steps

    def _feed_chunk(self, ch: dict) -> None:
        """The chunk's valid rows to the ingest, in (tick, env) order."""
        valid = ch["valid"]
        for k, j in zip(*np.nonzero(valid)):
            self.memory.feed(Transition(
                state0=ch["state0"][k, j], action=ch["action"][k, j],
                reward=ch["reward"][k, j], gamma_n=ch["gamma_n"][k, j],
                state1=ch["state1"][k, j],
                terminal1=ch["terminal1"][k, j],
                prov=make_prov(self.process_ind, j, self._feed_version,
                               self._birth_step)))

    def _flush_rows(self, step: int) -> None:
        """The stat cadence's rows: the timer's phases, the perf window
        and the tracer's spans."""
        self._writer.scalars(self.timer.drain(), step=step)
        if self.perf.enabled:
            self._writer.scalars(self.perf.drain(step=step), step=step)
        self.tracer.flush_to(self._writer, step=step)

    def shutdown(self) -> None:
        if self._prefetch is not None:
            self._prefetch.close()
        if self.engine is not None:
            self.engine.close()
        self._flush_stats()
        self.memory.flush()
        self.memory.close()
        step = self.clock.learner_step.value
        if self.perf.enabled:  # the last partial window: a short run's rate
            self._writer.scalars(self.perf.drain(step=step), step=step)
        self.tracer.flush_to(self._writer, step=step)
        self._writer.close()


def fold_rollout_episode_stats(step_reward, step_terminal, episode_reward,
                               episode_steps, acc: dict) -> None:
    """Fold a fused dispatch's (K, N) per-tick env stats into the per-env
    episode accumulators (changed in place) and the actor stat dict
    (``ActorStats.FIELDS`` keys): one implementation for the device actor
    loop and the Anakin driver.  An episode counts as solved when its
    return is positive."""
    step_reward = np.asarray(step_reward)
    for k in range(step_reward.shape[0]):
        episode_reward += np.asarray(step_reward[k], np.float64)
        episode_steps += 1
        for j in np.nonzero(np.asarray(step_terminal[k]))[0]:
            acc["nepisodes"] += 1
            acc["nepisodes_solved"] += float(episode_reward[j] > 0)
            acc["total_steps"] += float(episode_steps[j])
            acc["total_reward"] += float(episode_reward[j])
            episode_steps[j] = 0
            episode_reward[j] = 0.0


class DdpgActor(DqnActor):
    """The DDPG actor: the harness with the policy's engines and the OU
    process (see the module docstring)."""

    def __init__(self, opt: Options, spec: EnvSpec, process_ind: int,
                 *args, **kwargs):
        n = max(1, opt.env_params.num_envs_per_actor)
        ap = opt.agent_params
        self.ou = OrnsteinUhlenbeckProcess(
            size=n * spec.action_dim, theta=ap.ou_theta, mu=ap.ou_mu,
            sigma=ap.ou_sigma,
            n_steps_annealing=opt.memory_params.memory_size * 100,
            seed=ou_seed(opt.seed, process_ind))
        super().__init__(opt, spec, process_ind, *args, **kwargs)

    def _noise(self, actions: np.ndarray) -> np.ndarray:
        return ou_explore(self.ou, actions)

    def _batched_engine(self, inference, eps, gen, spec):
        return _BatchedDdpgEngine(inference, self._noise)

    def _local_engine(self, opt, spec, model, eps, gen, device, stream):
        return _DdpgEngine(module_apply(model), self._noise, self.num_envs,
                           spec.action_dim, spec.state_shape, device, stream,
                           pipelined=self.backend == "pipelined")

    def on_env_reset(self, j: int) -> None:
        # a fresh noise path per episode, per env
        self.ou.x_prev.reshape(self.num_envs, -1)[j] = self.ou.x0


def actor_class(agent_type: str):
    """The actor of each agent family (reference factory.py:78-93).  The
    recurrent actor builds on ``DqnActor``, so its module is imported
    here, when the table is read."""
    from pytorch_distributed_tpu_torch.agents.recurrent_actor import (
        RecurrentActor,
    )

    return {"dqn": DqnActor, "ddpg": DdpgActor,
            "r2d2": RecurrentActor}[agent_type]


def run_actor(opt: Options, spec: EnvSpec, process_ind: int, memory: Any,
              param_store: ParamStore, clock: GlobalClock,
              stats: ActorStats, inference: Any = None) -> int:
    """Collect experience with the run's family's actor until the learner
    clock ends the run; under ``batched`` through the client
    ``inference``.  Returns the env steps this actor took."""
    return actor_class(opt.agent_type)(opt, spec, process_ind, memory,
                                       param_store, clock, stats,
                                       inference).run()


class RecordingSink:
    """A feeder that keeps every transition it is fed, for bounded runs."""

    def __init__(self):
        self.items: List[Any] = []

    def set_stop(self, event) -> None:
        pass

    def feed(self, transition) -> None:
        self.items.append(transition)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class _BoundedClock:
    """Quacks like ``GlobalClock``; ends the loop after ``ticks`` ticks
    instead of at a learner step, and calls ``on_tick(k)``, if set, as
    tick k starts."""

    def __init__(self, ticks: int):
        self._ticks = self._left = ticks
        self.on_tick = None
        self.stop = threading.Event()
        self.learner_step = types.SimpleNamespace(value=0)

    def done(self, steps: int) -> bool:
        if self._left <= 0:
            return True
        if self.on_tick is not None:
            self.on_tick(self._ticks - self._left)
        self._left -= 1
        return False

    def add_actor_steps(self, n: int = 1) -> int:
        return n


def snapshot_store(opt: Options, spec: EnvSpec, seed: int = 0
                   ) -> ParamStore:
    """A ``ParamStore`` holding one published snapshot,
    ``init_params(seed=seed)``: what a bounded run's actor, or the
    inference server it talks to, reads its weights from."""
    flat = make_flattener(init_params(opt, spec, seed=seed),
                          spec.state_shape)[0]
    store = ParamStore(flat.size)
    store.publish(flat)
    return store


def bounded_actor_run(opt: Options, ticks: int, spec: EnvSpec = None,
                      process_ind: int = 0, param_seed: int = 0,
                      publish_at: Optional[int] = None,
                      inference: Any = None) -> dict:
    """Run ONE actor in this thread for exactly ``ticks`` ticks against
    one published snapshot (``init_params(seed=param_seed)``) and a
    ``RecordingSink``: the harness of the schedule-equivalence tests and
    of ``chip_smoke.py``'s ``actor_tick``.  With ``publish_at``, a second
    snapshot (``seed=param_seed + 1``) is published as that tick starts,
    and the tick waits until the actor's prefetcher has loaded it, so the
    actor swaps it in at its next sync point whatever the schedule.
    Under ``batched`` the actor talks to the server through the client
    ``inference`` and acts on the server's weights: build the server on
    ``snapshot_store(opt, spec, param_seed)`` for the same snapshot
    (``publish_at`` needs a prefetcher, so it is refused there).
    Returns ``{"stream": the transitions fed, "timer_ms": the StepTimer's
    drain over the run, "env_steps", "version": the weights' version at
    the end, "seconds"}``; set ``actor_freq`` above ``ticks * num_envs``
    to keep the timer whole."""
    spec = spec if spec is not None else probe_env(opt)
    store = snapshot_store(opt, spec, param_seed)
    second = None
    if publish_at is not None:
        if inference is not None:
            raise ValueError("publish_at swaps weights in the actor; a "
                             "batched actor has none")
        second = make_flattener(init_params(opt, spec, seed=param_seed + 1),
                                spec.state_shape)[0]
    sink = RecordingSink()
    clock = _BoundedClock(ticks)
    actor = actor_class(opt.agent_type)(opt, spec, process_ind, sink, store,
                                        clock, ActorStats(), inference)

    def publish(k: int) -> None:
        if k == publish_at:
            version = store.publish(second)
            deadline = time.monotonic() + 60.0
            while actor._prefetch.version < version:
                if time.monotonic() > deadline:
                    raise TimeoutError("the prefetcher did not load the "
                                       "second snapshot")
                time.sleep(0.001)

    clock.on_tick = publish
    t0 = time.perf_counter()
    env_steps = actor.run()
    return {"stream": sink.items,
            "timer_ms": actor.timer.drain(), "env_steps": env_steps,
            "version": actor.version, "seconds": time.perf_counter() - t0}
