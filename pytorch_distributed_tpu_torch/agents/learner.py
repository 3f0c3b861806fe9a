"""The learner loop — the port of the device-PER branch of
pytorch_distributed_tpu/agents/learner.py ``run_learner`` (:56-, :299-351,
:474-760): attach the ring on the run's device, publish the initial
weights, wait for ``learn_start`` rows, then loop until ``steps``:

- ``max_replay_ratio`` pacing (keep draining while throttled, so a full
  ingest queue never blocks the actors that advance the clock);
- drain the ingest queue into the ring;
- one fused dispatch of K = ``steps_per_dispatch`` sub-steps of sample ->
  train -> priority write-back (memory/device_per.py), on uniforms drawn
  from the learner's device generator; on a GPU it is replayed from a
  CUDA graph;
- beta annealed on the dispatch cadence;
- a published snapshot every ``param_publish_freq`` steps, and a stats
  line every ``learner_freq`` steps (boundary crossings, so K > 1 never
  skips one).

Returns a summary of the run (steps, updates per second, the last
metrics, the skipped-step count, and the host seconds spent pacing,
draining, dispatching and publishing), which ``main`` prints.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from pytorch_distributed_tpu_torch.agents.clocks import GlobalClock
from pytorch_distributed_tpu_torch.agents.param_store import ParamStore
from pytorch_distributed_tpu_torch.config import Options
from pytorch_distributed_tpu_torch.factory import (
    EnvSpec, build_model, build_train_state_and_step, init_params,
    resolve_device, role_seed,
)
from pytorch_distributed_tpu_torch.memory.device_per import GraphedFusedStep
from pytorch_distributed_tpu_torch.memory.device_replay import (
    DevicePerIngest,
)
from pytorch_distributed_tpu_torch.ops.cuda_sampling import (
    hierarchical_sample,
)
from pytorch_distributed_tpu_torch.ops.cuda_torso import (
    COUNTERS as GEMM_COUNTERS,
)
from pytorch_distributed_tpu_torch.ops.losses import SKIPPED_KEY


def run_learner(opt: Options, spec: EnvSpec, process_ind: int,
                memory: DevicePerIngest, param_store: ParamStore,
                clock: GlobalClock) -> Dict[str, float]:
    ap = opt.agent_params
    device = resolve_device(opt)
    model = build_model(opt, spec)
    params = init_params(opt, spec, seed=opt.seed, device=device)
    state, step_fn = build_train_state_and_step(opt, model, params)
    param_store.publish(state.params)  # actors block on version 1

    replay = memory.attach(device)
    K = max(1, ap.steps_per_dispatch)
    fused = replay.build_fused_step(step_fn, ap.batch_size,
                                    steps_per_call=K)
    if device.type == "cuda":
        fused = GraphedFusedStep(fused, replay.state,
                                 counters=(hierarchical_sample,
                                           *GEMM_COUNTERS))
    gen = torch.Generator(device=device).manual_seed(
        role_seed(opt.seed, "learner", process_ind))

    # gate until the replay warms up; clamped below the ring's capacity,
    # whose fill never exceeds it
    learn_start = min(ap.learn_start, memory.capacity - 1)
    deadline = (time.monotonic() + ap.max_seconds) if ap.max_seconds > 0 \
        else float("inf")
    while not clock.done(ap.steps) and time.monotonic() < deadline:
        memory.drain()
        if memory.size > learn_start:
            break
        time.sleep(0.01)

    lstep = lstep0 = 0
    clock.set_learner_step(lstep)
    metrics: Dict[str, torch.Tensor] = {}
    skipped = torch.zeros((), device=device)
    beta, next_beta = replay.beta(0), 0
    t_start = t_window = time.monotonic()
    window_lstep = lstep
    spent = dict.fromkeys(("pacing", "drain", "step", "publish"), 0.0)
    while lstep < ap.steps and not clock.stop.is_set() \
            and time.monotonic() < deadline:
        t0 = time.perf_counter()
        if ap.max_replay_ratio > 0:
            while (not clock.stop.is_set() and time.monotonic() < deadline
                   and (lstep - lstep0 + K) * ap.batch_size
                   > ap.max_replay_ratio * max(clock.actor_step, 1)):
                memory.drain()
                time.sleep(0.002)
            if clock.stop.is_set():
                break
        t1 = time.perf_counter()
        memory.drain()
        t2 = time.perf_counter()
        if lstep >= next_beta:  # beta anneals slowly: refresh every 64 K
            beta, next_beta = replay.beta(lstep), lstep + 64 * K
        us = torch.rand((K, ap.batch_size), generator=gen, device=device)
        state, metrics = fused(state, replay.state, us, beta)
        skipped = skipped + metrics.get(SKIPPED_KEY, 0.0)
        prev, lstep = lstep, lstep + K
        clock.set_learner_step(lstep)
        t3 = time.perf_counter()

        crossed = lambda freq: freq and lstep // freq != prev // freq
        if crossed(ap.param_publish_freq):
            param_store.publish(state.params)
        t4 = time.perf_counter()
        for key, dt in zip(spent, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            spent[key] += dt
        if crossed(ap.learner_freq):
            now = time.monotonic()
            vals = {k: float(v) for k, v in metrics.items()}
            print(f"[learner] step {lstep} "
                  f"loss {vals['learner/critic_loss']:.5g} "
                  f"q_mean {vals['learner/q_mean']:.5g} "
                  f"{(lstep - window_lstep) / max(now - t_window, 1e-9):.1f}"
                  f" updates/s replay {memory.size}", flush=True)
            t_window, window_lstep = now, lstep
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.monotonic() - t_start
    summary = {k: float(v) for k, v in metrics.items()}
    summary.update({
        "learner/steps": lstep,
        "learner/updates_per_sec": lstep / max(seconds, 1e-9),
        "learner/train_seconds": seconds,
        SKIPPED_KEY: float(skipped),
        **{f"learner/host_s_{k}": v for k, v in spent.items()},
        "replay/size": memory.size,
        "actor/steps": clock.actor_step,
    })
    return summary
