"""Evaluator worker: periodic greedy evaluation and the params
checkpoints — the port of pytorch_distributed_tpu/agents/evaluator.py
(``greedy_episodes`` :46-104, its dqn, DDPG and r2d2 branches (:57-79,
:80-88),
with the ``render()`` calls of :93-116, and ``run_evaluator`` :106-248; with
``env_params.render`` its env dumps frames, utils/render.py).

A capture thread snapshots ``(weights, learner_step, wall)`` every
``evaluator_freq`` seconds, keeping at most ``MAX_BACKLOG`` snapshots
(the oldest drop first); the evaluation loop runs
``evaluator_nepisodes`` greedy episodes on each snapshot, oldest first,
hands the stats to the logger through the ``EvaluatorStats`` handshake,
attributed to the step and wall time of the capture, and writes the
params checkpoint, plus the ``_best`` tier when the score beats the best
so far.  When the run ends it evaluates the finished weights once more,
and then raises the handshake's ``done``.

Inference is one observation at a time, through the port's ``greedy_act``
on the module's forward (DDPG: ``ddpg_act``, the policy's action with no
noise, in [-1, 1]; the env rescales it; R2D2: ``recurrent_greedy_act``
from a zero carry at each episode's start, the carry kept across the
episode's steps): on the CPU in the evaluator, as
the reference pins its evaluator to the CPU, and on the run's device in
the tester.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch.agents.clocks import (
    EvaluatorStats, GlobalClock,
)
from pytorch_distributed_tpu_torch.agents.param_store import (
    ParamStore, make_flattener,
)
from pytorch_distributed_tpu_torch.config import Options
from pytorch_distributed_tpu_torch.factory import (
    EnvSpec, build_env, build_model, module_apply,
)
from pytorch_distributed_tpu_torch.models.policies import (
    ddpg_act, greedy_act, recurrent_greedy_act,
)
from pytorch_distributed_tpu_torch.utils import checkpoint as ckpt
from pytorch_distributed_tpu_torch.utils.render import attach_frame_dumper

MAX_BACKLOG = 8


def greedy_episodes(opt: Options, spec: EnvSpec, model: torch.nn.Module,
                    params: Dict[str, torch.Tensor], env, nepisodes: int,
                    device: torch.device = torch.device("cpu")
                    ) -> Tuple[float, float, int]:
    """Run ``nepisodes`` greedy episodes with inference on ``device`` (the
    evaluator's CPU by default); returns ``(avg_steps, avg_reward,
    solved)``."""
    apply_fn = module_apply(model.to(device))
    params = {k: v.detach().to(device) for k, v in params.items()}
    carry = None  # the recurrent policy's, zero at each episode's start

    def pick(obs):
        nonlocal carry
        x = torch.from_numpy(obs[None]).to(device)
        if opt.agent_type == "ddpg":
            return ddpg_act(apply_fn, params, x)[0].cpu().numpy()
        if opt.agent_type == "r2d2":
            a, carry = recurrent_greedy_act(apply_fn, params, x, carry)
            return int(a[0])
        a, _ = greedy_act(apply_fn, params, x)
        return int(a[0])

    total_steps, total_reward, solved = 0, 0.0, 0
    for _ in range(nepisodes):
        carry = model.zero_carry(1, device) if opt.agent_type == "r2d2" \
            else None
        obs = env.reset()
        env.render()  # a no-op unless a FrameDumper is attached
        ep_reward, ep_steps, terminal, info = 0.0, 0, False, {}
        while not terminal:
            obs, r, terminal, info = env.step(pick(obs))
            env.render()
            ep_reward += float(r)
            ep_steps += 1
        total_steps += ep_steps
        total_reward += ep_reward
        solved += int(bool(info.get("solved", ep_reward > 0)))
    return total_steps / nepisodes, total_reward / nepisodes, solved


def run_evaluator(opt: Options, spec: EnvSpec, process_ind: int, memory: Any,
                  param_store: ParamStore, clock: GlobalClock,
                  stats: EvaluatorStats) -> None:
    ap = opt.agent_params
    # the seed slot past the whole actor fleet
    fleet = opt.num_actors * max(1, opt.env_params.num_envs_per_actor)
    env = build_env(opt, process_ind=fleet + 1)
    env.eval()
    if opt.env_params.render:
        attach_frame_dumper(env, opt.log_dir, "evaluator")
    model = build_model(opt, spec)
    _flat0, unflatten = make_flattener(model.state_dict(), spec.state_shape)

    snapshots: deque = deque()
    snap_lock = threading.Lock()

    def capture_loop() -> None:
        version, flat = 0, None
        last_cap = float("-inf")  # capture at once when weights exist
        while not clock.done(ap.steps):
            time.sleep(0.25)
            if time.monotonic() - last_cap < ap.evaluator_freq:
                continue
            got = param_store.fetch(version)
            if got is not None:
                flat, version = got
            if flat is None:
                continue  # nothing published yet
            last_cap = time.monotonic()
            with snap_lock:
                if len(snapshots) >= MAX_BACKLOG:
                    snapshots.popleft()
                snapshots.append((flat, clock.learner_step.value,
                                  time.time()))

    cap_thread = threading.Thread(target=capture_loop, name="eval-capture",
                                  daemon=True)
    cap_thread.start()

    def evaluate(flat: np.ndarray, at_step: int, at_wall: float) -> None:
        params = unflatten(flat)
        avg_steps, avg_reward, solved = greedy_episodes(
            opt, spec, model, params, env, ap.evaluator_nepisodes)
        # the handshake holds one result: wait for the logger to take the
        # last one rather than overwrite it
        waited = time.monotonic() + 10.0
        while stats.flag.value and time.monotonic() < waited \
                and not clock.stop.is_set():
            time.sleep(0.05)
        stats.publish(at_step, wall=at_wall, avg_steps=avg_steps,
                      avg_reward=avg_reward,
                      nepisodes=float(ap.evaluator_nepisodes),
                      nepisodes_solved=float(solved))
        # snapshots are evaluated oldest first, so the last write is the
        # newest
        ckpt.save_params(ckpt.params_path(opt.model_name), params)
        with clock.best_eval_reward.get_lock():
            is_best = avg_reward > clock.best_eval_reward.value
            if is_best:
                clock.best_eval_reward.value = avg_reward
        if is_best:  # the score first (checkpoint.save_best_score)
            ckpt.save_best_score(opt.model_name, avg_reward, step=at_step)
            ckpt.save_params(ckpt.params_path(opt.model_name + "_best"),
                             params)

    def pop_snapshot():
        with snap_lock:
            return snapshots.popleft() if snapshots else None

    # the hang watchdog's liveness mark (reference :218-230), on every
    # poll and after every evaluation: a stuck episode goes stale, a
    # starved evaluator does not
    bump = getattr(clock, "bump_progress", lambda label: None)
    try:
        while not clock.done(ap.steps):
            bump("evaluator-0")
            snap = pop_snapshot()
            if snap is None:
                time.sleep(0.1)
                continue
            evaluate(*snap)
            bump("evaluator-0")
        # the finished weights, always fetched fresh; the backlog only if
        # nothing was ever published
        cap_thread.join(timeout=2.0)
        got = param_store.fetch(0)
        if got is not None:
            snap = (got[0], clock.learner_step.value, time.time())
        else:
            with snap_lock:
                snap = snapshots.pop() if snapshots else None
        if snap is not None:
            evaluate(*snap)
    finally:
        stats.done.value = 1
