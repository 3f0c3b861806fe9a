"""Actor workers: epsilon-greedy experience collection — the port of the
inline loop of pytorch_distributed_tpu/agents/actor.py (``_ActorHarness``,
``_LocalDqnEngine`` :415, ``_drive_actor_loop`` :524, ``run_dqn_actor``
:748).

Each actor steps ``num_envs_per_actor`` Pong simulators as one vector,
runs ONE batched forward per tick, assembles n-step transitions per env
and feeds them to the ingest queue.  Exploration follows Ape-X over the
whole fleet: env j of actor i takes slot i*N + j.  The weights are the
learner's newest published vector (agents/param_store.py), fetched every
``actor_sync_freq`` env steps and unflattened into tensors.  Per-tick
randomness (explore uniforms and random actions) comes from the actor's
own ``torch.Generator``, seeded from ``--seed`` and the actor index, so
both backends draw the same streams.

Where an actor infers: a child process of the process backend on the CPU,
as the reference pins every child there (runtime.py:53-70; its actors
call ``pin_to_cpu``, actor.py:425), so only the learner's process holds a
CUDA context.  A thread of the thread backend infers on the run's device;
on a GPU each runs on a high-priority CUDA stream of its own, so its
per-tick copy of the actions back to the host waits for its own forward
and not for the learner's queued updates.

Backends: ``inline`` runs this loop; ``pipelined`` (the default) runs the
same loop, as the reference pins both to one action stream
(tests/test_actor_pipeline.py there); ``batched``, ``device`` and
``anakin`` are not ported yet.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from pytorch_distributed_tpu_torch.agents.clocks import ActorStats, GlobalClock
from pytorch_distributed_tpu_torch.agents.param_store import (
    ParamStore, make_flattener,
)
from pytorch_distributed_tpu_torch.config import Options
from pytorch_distributed_tpu_torch.factory import (
    EnvSpec, build_env_vector, build_model, module_apply, resolve_device,
    role_seed,
)
from pytorch_distributed_tpu_torch.models.policies import (
    apex_epsilons, epsilon_greedy_act,
)
from pytorch_distributed_tpu_torch.ops.nstep import NStepAssembler

_NOT_PORTED_BACKENDS = {
    "batched": "the shared inference server (ROADMAP.md, Queue A, "
               "\"The actor fast path and co-location\")",
    "device": "the device env rollout (ROADMAP.md, Queue A, \"The actor "
              "fast path and co-location\")",
    "anakin": "the co-located Anakin loop (ROADMAP.md, Queue A, \"The "
              "actor fast path and co-location\")",
}


def resolve_actor_backend(opt: Options) -> str:
    backend = opt.env_params.actor_backend
    if backend in _NOT_PORTED_BACKENDS:
        raise NotImplementedError(
            f"actor_backend={backend!r} needs "
            f"{_NOT_PORTED_BACKENDS[backend]}, which is not ported yet")
    if backend not in ("pipelined", "inline"):
        raise ValueError(f"unknown actor_backend {backend!r}")
    return backend


def run_dqn_actor(opt: Options, spec: EnvSpec, process_ind: int,
                  memory: Any, param_store: ParamStore, clock: GlobalClock,
                  stats: ActorStats) -> int:
    """Collect experience until the learner clock ends the run.  Returns
    the env steps this actor took."""
    backend = resolve_actor_backend(opt)
    if backend == "pipelined" and process_ind == 0:
        print("[actor] actor_backend=pipelined runs the inline loop in this "
              "port (same action stream)", flush=True)
    ap = opt.agent_params
    device = resolve_device(opt)
    n = max(1, opt.env_params.num_envs_per_actor)
    env = build_env_vector(opt, process_ind, n)
    # the module gives the forward its structure; the weights are always
    # the published vector's
    model = build_model(opt, spec)
    apply_fn = module_apply(model)
    _flat0, unflatten = make_flattener(model.state_dict(), spec.state_shape)

    eps = torch.as_tensor(apex_epsilons(process_ind, opt.num_actors, n,
                                        ap.eps, ap.eps_alpha), device=device)
    gen = torch.Generator().manual_seed(role_seed(opt.seed, "actor",
                                                  process_ind))
    stream = (torch.cuda.Stream(device, priority=-1)
              if device.type == "cuda" else None)

    def load(flat):
        with torch.cuda.stream(stream):  # a no-op for None
            return {k: v.to(device) for k, v in unflatten(flat).items()}

    memory.set_stop(clock.stop)
    flat, version = param_store.wait(0, stop=clock.stop)
    params = load(flat)
    assemblers = [NStepAssembler(ap.nstep, ap.gamma) for _ in range(n)]
    episode_reward = np.zeros(n)
    episode_steps = np.zeros(n, dtype=np.int64)
    acc = dict.fromkeys(ActorStats.FIELDS, 0.0)
    env_steps, next_sync, next_flush = 0, ap.actor_sync_freq, ap.actor_freq

    obs = env.reset()
    while not clock.done(ap.steps):
        explore_u = torch.rand(n, generator=gen)
        random_a = torch.randint(spec.num_actions, (n,), generator=gen)
        with torch.cuda.stream(stream):  # a no-op for None
            action, _q_sel, _q_max = epsilon_greedy_act(
                apply_fn, params, torch.from_numpy(obs).to(device), eps,
                explore_u.to(device), random_a.to(device))
            actions = action.cpu().numpy()
        next_obs, rewards, terminals, infos = env.step(actions)
        env_steps += n
        clock.add_actor_steps(n)
        acc["total_nframes"] += n
        if env_steps >= next_sync:
            next_sync += ap.actor_sync_freq
            got = param_store.fetch(version)
            if got is not None:
                flat, version = got
                params = load(flat)
        for j in range(n):
            true_next = infos[j].get("final_obs", next_obs[j])
            for t in assemblers[j].feed(
                    obs[j], actions[j], float(rewards[j]), true_next,
                    bool(terminals[j]),
                    truncated=bool(infos[j].get("truncated", False))):
                memory.feed(t)
            episode_reward[j] += float(rewards[j])
            episode_steps[j] += 1
            if terminals[j]:  # reference actor.py:292-299
                acc["nepisodes"] += 1
                acc["nepisodes_solved"] += float(bool(infos[j].get(
                    "solved", episode_reward[j] > 0)))
                acc["total_steps"] += float(episode_steps[j])
                acc["total_reward"] += episode_reward[j]
                episode_reward[j] = 0.0
                episode_steps[j] = 0
        obs = next_obs
        if env_steps >= next_flush:
            next_flush += ap.actor_freq
            stats.add(**acc)
            acc = dict.fromkeys(ActorStats.FIELDS, 0.0)
            memory.flush()
    stats.add(**acc)
    memory.flush()
    memory.close()
    return env_steps
