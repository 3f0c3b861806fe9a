"""The co-located Anakin loop — the port of
pytorch_distributed_tpu/agents/anakin.py: ``resolve_anakin`` (:65-90),
``AnakinDriver`` (:92-647) and ``run_anakin_learner`` (:649-659).

The env fleet and the learner share one process and one device:

- the fleet is ``num_actors x num_envs_per_actor`` envs as one device env
  (envs/device_env.py) on the fleet's slot and epsilon contract (env j of
  virtual actor i takes seed slot and epsilon slot i*N + j);
- one driver alternates the fused rollout with ``emit="replay"``
  (models/policies.py: the valid rows go straight into the ring at its
  device cursor; on the PER ring new rows at the running max priority,
  ``memory/device_per.per_write_masked``) and the learner's fused
  dispatch (memory/device_per.py, or memory/device_replay.py for the
  uniform ring of row 8) on the same ring: no actor process, no queue, no
  copy of experience to the host;
- the learner's dispatch is resolved as the split learner's
  (``factory.resolve_fused_step``, reference :255-275): with
  ``megabatch`` M > 1 it runs K/M group steps, K rounded up to a multiple
  of M;
- the rollout acts on the train state's params, copied into its graph's
  weights before each dispatch: the acting version is the newest;
- a duty-cycle scheduler (``AnakinParams.rollout_ratio``) aims at a ratio
  of env frames to updates; 0 is strict alternation, the schedule the
  parity test pins (tests/test_torch_anakin.py: bit-identical to the
  ``device`` path driven to the same schedule);
- ``AnakinParams.double_buffer`` splits the ring into two halves: learner
  dispatches sample the stable half while rollouts write the other, and
  they swap once the write half holds ``min_fill`` fresh rows.

On a GPU both programs are CUDA graphs replayed in turn on the learner's
stream: the learner's ``GraphedFusedStep`` (one per ring) and the
rollout's graph (one per ring it writes).  The per-tick env stats come
back by a non-blocking copy into one of two pinned buffers and are
folded into the episode counts once the next rollout is launched, so
the host never waits for the rollout it just launched; the duty cycle is the rollouts' share of the device time
that CUDA events measure around each dispatch (host time on the CPU,
where every dispatch blocks).  ``max_replay_ratio`` does not apply.

Publication (``DevicePublisher``), checkpoint epochs (with ``lstep0`` and
``actor_step``; ``--resume`` seeds the cumulative frame count from
``actor_step``, so the scheduler does not flood rollouts after a
restart), the ``learner_freq`` stats, the liveness mark and SIGTERM are
the learner's (agents/learner.py), and so are the initial params
(``initial_params``: ``--model-file`` fine-tunes).  As in the reference
(:176-179) the Anakin loop keeps no rollback ladder.  Knobs:
``config.AnakinParams``, each overridable as ``TPU_APEX_ANAKIN_<FIELD>``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from pytorch_distributed_tpu_torch.agents.actor import (
    fold_rollout_episode_stats,
)
from pytorch_distributed_tpu_torch.agents.clocks import ActorStats
from pytorch_distributed_tpu_torch.agents.learner import (
    EpochSaver, initial_params, restore_epoch, resume_epoch,
)
from pytorch_distributed_tpu_torch.agents.param_store import (
    DevicePublisher, flatten_into,
)
from pytorch_distributed_tpu_torch.config import AnakinParams, Options
from pytorch_distributed_tpu_torch.factory import (
    anakin_eligible, build_device_env, build_model,
    build_train_state_and_step, module_apply, resolve_device,
    resolve_fused_step, role_seed,
)
from pytorch_distributed_tpu_torch.memory.device_per import (
    GraphedFusedStep, per_write_masked,
)
from pytorch_distributed_tpu_torch.models.policies import (
    apex_epsilons, build_fused_rollout, init_rollout_carry,
)
from pytorch_distributed_tpu_torch.ops.cuda_sampling import (
    hierarchical_sample,
)
from pytorch_distributed_tpu_torch.ops.cuda_torso import (
    COUNTERS as GEMM_COUNTERS,
)
from pytorch_distributed_tpu_torch.ops.losses import SKIPPED_KEY
from pytorch_distributed_tpu_torch.utils import checkpoint as ckpt
from pytorch_distributed_tpu_torch.utils.metrics import MetricsWriter
from pytorch_distributed_tpu_torch.utils.profiling import StepTimer

_ENV_PREFIX = "TPU_APEX_ANAKIN_"


def resolve_anakin(an: Optional[AnakinParams] = None) -> AnakinParams:
    """``AnakinParams`` with the ``TPU_APEX_ANAKIN_<FIELD>`` overrides of
    the environment applied; a new instance, the input is not changed."""
    an = an if an is not None else AnakinParams()
    changes: dict = {}
    for f in dataclasses.fields(an):
        raw = os.environ.get(_ENV_PREFIX + f.name.upper())
        if raw is None:
            continue
        cur = getattr(an, f.name)
        if isinstance(cur, bool):
            changes[f.name] = raw.strip().lower() not in (
                "0", "false", "off", "no", "")
        elif isinstance(cur, int):
            changes[f.name] = int(float(raw))
        elif isinstance(cur, float):
            changes[f.name] = float(raw)
        else:
            changes[f.name] = raw.strip()
    return dataclasses.replace(an, **changes) if changes else an


class _HostClock:
    """Seconds per dispatch kind on the host clock: exact on the CPU,
    where every dispatch blocks."""

    def __init__(self):
        self._window: Dict[str, float] = {}

    def begin(self) -> float:
        return time.perf_counter()

    def end(self, kind: str, start: float) -> None:
        self._window[kind] = self._window.get(kind, 0.0) \
            + time.perf_counter() - start

    def drain(self) -> Dict[str, float]:
        out, self._window = self._window, {}
        return out


class _DeviceClock(_HostClock):
    """Device seconds per dispatch kind from CUDA events recorded around
    each dispatch on the current stream.  Finished marks are folded into
    the window as they complete, so the list stays short without a wait;
    ``drain`` waits for the last one."""

    def __init__(self):
        super().__init__()
        self._marks: list = []

    def begin(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def end(self, kind: str, start) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._marks.append((kind, start, ev))
        while len(self._marks) > 64 and self._marks[0][2].query():
            self._fold(self._marks.pop(0))

    def _fold(self, mark) -> None:
        kind, a, b = mark
        self._window[kind] = self._window.get(kind, 0.0) \
            + a.elapsed_time(b) / 1e3

    def drain(self) -> Dict[str, float]:
        if self._marks:
            self._marks[-1][2].synchronize()
        for mark in self._marks:
            self._fold(mark)
        self._marks = []
        return super().drain()


class AnakinDriver:
    """The co-located act -> store -> sample -> learn driver.  It owns the
    train state, the device env fleet, the fused rollout and learner
    programs and the ring(s).  ``dispatch_rollout``/``dispatch_learn``
    are public so tests can drive a fixed schedule; ``run`` is the
    production loop with the learner's cadences and returns its
    summary."""

    def __init__(self, opt: Options, spec, memory: Any, param_store,
                 clock, learner_stats=None, actor_stats=None,
                 process_ind: int = 0):
        ok, why = anakin_eligible(opt)
        if not ok:
            raise RuntimeError(f"anakin driver on an ineligible config: "
                               f"{why}")
        self.opt, self.ap = opt, opt.agent_params
        self.an = resolve_anakin(opt.anakin_params)
        self.memory, self.param_store, self.clock = memory, param_store, clock
        self.learner_stats = learner_stats
        self.actor_stats = (actor_stats if actor_stats is not None
                            else ActorStats())
        self.spec = spec
        ap = self.ap
        self.device = device = resolve_device(opt)
        self.cuda = device.type == "cuda"

        # ---- the learner half, as run_learner builds it ----
        model = build_model(opt, spec)
        params = initial_params(opt, spec, device)
        self.state, step_fn = build_train_state_and_step(opt, model, params)
        epoch = resume_epoch(opt)
        if epoch is not None:
            self.state = restore_epoch(opt, epoch, clock, device, "anakin")
        self._host_flat = torch.empty(param_store.num_params)

        # ---- ring(s): one, or two halves ----
        self.is_per = memory.prioritized
        self.rings = (list(memory.attach_halves(device))
                      if self.an.double_buffer else [memory.attach(device)])
        self.sample_ix = self.write_ix = 0
        self._fresh = 0  # rows into the write half since the last swap
        half_cap = self.rings[0].capacity
        mf = self.an.min_fill or min(ap.learn_start, half_cap - 1)
        self.min_fill = max(1, min(int(mf), half_cap))
        # host fill accounting per ring: the rollout's row count is a pure
        # function of its tick window, so no device read is needed
        self._fill = [0 for _ in self.rings]
        self.restored_rows = 0
        if epoch is not None and opt.memory_params.checkpoint_replay:
            self.restored_rows = ckpt.load_epoch_replay(epoch, memory)
            self._fill[0] = min(self.restored_rows, half_cap)
            if self.restored_rows:
                print(f"[anakin] replay restored from epoch {epoch.epoch}: "
                      f"{self.restored_rows} rows", flush=True)

        # ---- the co-located fleet and its rollout, one per write ring ----
        A = max(1, opt.num_actors)
        N = max(1, opt.env_params.num_envs_per_actor)
        self.fleet_envs = A * N
        self.env = build_device_env(opt, 0, self.fleet_envs, device)
        self.K_roll = max(1, int(opt.env_params.device_rollout_ticks))
        eps = apex_epsilons(0, 1, self.fleet_envs, ap.eps, ap.eps_alpha)
        apply_fn = module_apply(model)
        self.rollouts = [build_fused_rollout(
            apply_fn, self.env, nstep=ap.nstep, gamma=ap.gamma,
            rollout_ticks=self.K_roll, eps=eps, emit="replay",
            ring=r.state,
            ring_write_fn=per_write_masked if self.is_per else None)
            for r in self.rings]
        self.carry = init_rollout_carry(self.env, ap.nstep)
        self.act_gen = torch.Generator(device=device).manual_seed(
            role_seed(opt.seed, "actor", 0))

        # ---- the learner's fused dispatch, one per ring it samples ----
        M, K, mega_step = resolve_fused_step(opt, model, "anakin")
        self.K_learn = K
        self._fused = [r.build_fused_step(step_fn, ap.batch_size,
                                          steps_per_call=K, megabatch=M,
                                          megabatch_step=mega_step)
                       for r in self.rings]
        if self.cuda:
            self._fused = [GraphedFusedStep(f, r.state, counters=(
                hierarchical_sample, *GEMM_COUNTERS))
                for f, r in zip(self._fused, self.rings)]
        self.gen = torch.Generator(device=device).manual_seed(
            role_seed(opt.seed, "learner", process_ind))
        self.lstep = self.lstep0 = int(self.state.step)
        # duty-cycle input: cumulative frames against cumulative updates;
        # a resume seeds both, or the scheduler would read the restored
        # updates as a frame deficit and run rollouts only
        self.frames = 0
        if epoch is not None:
            self.lstep0 = int(epoch.extras.get("lstep0", self.lstep0))
            self.frames = int(epoch.extras.get("actor_step", 0))
            ckpt.restore_torch_rng(
                self.gen, epoch.extras.get("rng", {}).get("learner_device"))
        self.lstep_resumed = self.lstep
        clock.set_learner_step(self.lstep)
        self._beta = self.rings[0].beta(0) if self.is_per else None
        self._next_beta = 0
        self._skipped = torch.zeros((), device=device)
        self._last_metrics: Dict[str, torch.Tensor] = {}
        self._last_was_rollout = False

        # episode accounting (the actor's, fleet-wide) and its cadence
        self.episode_reward = np.zeros(self.fleet_envs, dtype=np.float64)
        self.episode_steps = np.zeros(self.fleet_envs, dtype=np.int64)
        self._acc = dict.fromkeys(ActorStats.FIELDS, 0.0)
        self.env_steps = 0
        self._next_flush = ap.actor_freq
        # two host buffers of a dispatch's env stats, in turn, so the
        # previous dispatch's are read after this one is launched
        self._pinned: list = []
        self._pending = None  # (pinned reward, pinned terminal, event)
        self.counts = dict(rollouts=0, learns=0)
        self.timer = StepTimer("anakin")
        # device time on a GPU, host time on the CPU
        self.dispatch_clock = _DeviceClock() if self.cuda else _HostClock()
        self._window_frames = 0
        self.totals = dict(rollout=0.0, learn=0.0)
        self.writer = MetricsWriter(opt.log_dir, role="learner",
                                    run_id=opt.refs)
        self.publisher = None
        self.saver = EpochSaver(opt, clock, memory, device)

    # -- helpers -------------------------------------------------------

    def publish_inline(self) -> None:
        flatten_into({k: v.detach().cpu()
                      for k, v in self.state.params.items()},
                     self._host_flat, self.spec.state_shape)
        self.param_store.publish(self._host_flat.numpy())

    def replay_fill(self) -> float:
        """Share of the total ring capacity holding rows (host
        accounting; both halves count)."""
        cap = sum(r.capacity for r in self.rings)
        return min(1.0, sum(self._fill) / max(cap, 1))

    def _maybe_swap(self) -> None:
        """The double buffer's schedule: the write half detaches from the
        sample half once it holds ``min_fill`` rows, then the halves swap
        whenever the write half has ``min_fill`` fresh rows.  Only between
        dispatches, so no learner dispatch samples a half a rollout
        writes."""
        if not self.an.double_buffer:
            return
        if self.write_ix == self.sample_ix:
            if self._fill[self.write_ix] >= self.min_fill:
                self.write_ix = 1 - self.write_ix
                self._fresh = 0
        elif self._fresh >= self.min_fill:
            self.sample_ix, self.write_ix = self.write_ix, self.sample_ix
            self._fresh = 0

    def want_rollout(self) -> bool:
        """The duty-cycle scheduler: rollouts until the sample ring holds
        ``min_fill`` rows, then the ``rollout_ratio`` frames-per-update
        setpoint or, at ratio 0, strict alternation."""
        self._maybe_swap()
        if self._fill[self.sample_ix] < self.min_fill:
            return True
        ratio = self.an.rollout_ratio
        if ratio > 0:
            return self.frames < (self.lstep - self.lstep0) * ratio
        return not self._last_was_rollout

    def _fold(self, step_reward, step_terminal) -> None:
        fold_rollout_episode_stats(step_reward, step_terminal,
                                   self.episode_reward, self.episode_steps,
                                   self._acc)

    def _fold_pending(self) -> None:
        """Fold the previous rollout's env stats once their copy to the
        host is done (GPU only)."""
        if self._pending is not None:
            r, t, ev = self._pending
            ev.synchronize()
            self._fold(r.numpy(), t.numpy())
            self._pending = None

    # -- the two dispatches ----------------------------------------------

    def dispatch_rollout(self):
        """One fused rollout into the write ring: K_roll ticks of the
        whole fleet, rows written in the program.  Returns its
        ``RolloutStats``."""
        t0 = time.perf_counter()
        rollout = self.rollouts[self.write_ix]
        start = self.dispatch_clock.begin()
        rollout.draw(self.act_gen)
        stats = rollout(self.state.params, self.carry)
        self.dispatch_clock.end("rollout", start)
        if self.cuda:
            # the previous rollout's copy was queued before this rollout:
            # the wait leaves this one and what follows queued
            self._fold_pending()
            if not self._pinned:
                self._pinned = [(torch.empty(stats.step_reward.shape,
                                             pin_memory=True),
                                 torch.empty(stats.step_terminal.shape,
                                             dtype=torch.bool,
                                             pin_memory=True))
                                for _ in range(2)]
            r, t = self._pinned[self.counts["rollouts"] % 2]
            r.copy_(stats.step_reward, non_blocking=True)
            t.copy_(stats.step_terminal, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            self._pending = (r, t, ev)
        else:
            self._fold(stats.step_reward.numpy(),
                       stats.step_terminal.numpy())
        fed = stats.rows
        frames = self.K_roll * self.fleet_envs
        self.frames += frames
        self._window_frames += frames
        self.clock.add_actor_steps(frames)
        ix = self.write_ix
        self._fill[ix] = min(self._fill[ix] + fed, self.rings[ix].capacity)
        self._fresh += fed
        self.memory.note_scatter(fed)
        self._last_was_rollout = True
        self.counts["rollouts"] += 1
        self._acc["total_nframes"] += frames
        self.env_steps += frames
        if self.env_steps >= self._next_flush:
            self._next_flush += self.ap.actor_freq
            self.flush_actor_stats()
        self.timer.add("rollout", time.perf_counter() - t0)
        return stats

    def flush_actor_stats(self) -> None:
        if any(self._acc.values()):
            self.actor_stats.add(**self._acc)
            self._acc = dict.fromkeys(self._acc, 0.0)

    def dispatch_learn(self) -> Dict[str, torch.Tensor]:
        """One fused learner dispatch (K_learn updates) on the sample
        ring, on uniforms from the learner's generator, as run_learner
        draws them."""
        t0 = time.perf_counter()
        ring = self.rings[self.sample_ix]
        if self.is_per and self.lstep >= self._next_beta:
            # refreshed every 64 K updates
            self._beta = self.rings[0].beta(self.lstep)
            self._next_beta = self.lstep + 64 * self.K_learn
        start = self.dispatch_clock.begin()
        us = torch.rand((self.K_learn, self.ap.batch_size),
                        generator=self.gen, device=self.device)
        self.state, m = self._fused[self.sample_ix](self.state, ring.state,
                                                    us, self._beta)
        self.dispatch_clock.end("learn", start)
        self._skipped = self._skipped + m.get(SKIPPED_KEY, 0.0)
        self._last_metrics = m
        self.lstep += self.K_learn
        self.clock.set_learner_step(self.lstep)
        self._last_was_rollout = False
        self.counts["learns"] += 1
        self.timer.add("learn", time.perf_counter() - t0)
        return m

    # -- epochs ----------------------------------------------------------

    def save_epoch(self) -> None:
        self.saver.save(self.state, self.lstep, self.lstep0, self.gen,
                        self._skipped)

    # -- the production loop ---------------------------------------------

    def _window_times(self) -> Dict[str, float]:
        got = self.dispatch_clock.drain()
        for k, v in got.items():
            self.totals[k] += v
        return got

    def _stats_line(self, now: float, t_window: float, lstep0: int) -> None:
        vals = {k: float(v) for k, v in self._last_metrics.items()}
        rate = (self.lstep - lstep0) / max(now - t_window, 1e-9)
        busy = self._window_times()
        total = busy.get("rollout", 0.0) + busy.get("learn", 0.0)
        duty = busy.get("rollout", 0.0) / total if total > 0 else 0.0
        frames_rate = self._window_frames / max(now - t_window, 1e-9)
        self._window_frames = 0
        print(f"[anakin] step {self.lstep} "
              f"loss {vals.get('learner/critic_loss', float('nan')):.5g} "
              f"{rate:.1f} updates/s {frames_rate:.0f} frames/s "
              f"duty {duty:.3f} replay {self.memory.size}", flush=True)
        if self.learner_stats is not None:
            self.learner_stats.add(
                counter=1,
                critic_loss=vals.get("learner/critic_loss", 0.0),
                q_mean=vals.get("learner/q_mean", 0.0),
                grad_norm=vals.get("learner/grad_norm", 0.0),
                steps_per_sec=rate)
        self.writer.scalars({"anakin/duty_cycle": duty,
                             "anakin/updates_per_s": rate,
                             "anakin/rollout_frames_per_s": frames_rate,
                             "anakin/replay_fill": self.replay_fill()},
                            step=self.lstep)
        self.writer.scalars(self.timer.drain(), step=self.lstep)

    def run(self) -> Dict[str, float]:
        ap, clock, memory = self.ap, self.clock, self.memory
        deadline = (time.monotonic() + ap.max_seconds) \
            if ap.max_seconds > 0 else float("inf")
        self.publish_inline()  # workers block on version 1
        if self.cuda:
            self.publisher = DevicePublisher(self.param_store,
                                             self.spec.state_shape,
                                             self.device)
        t_start = t_window = time.monotonic()
        window_lstep = self.lstep
        actor_step0 = clock.actor_step.value
        spent = dict.fromkeys(("drain", "publish"), 0.0)
        while self.lstep < ap.steps and not clock.stop.is_set() \
                and time.monotonic() < deadline:
            clock.bump_progress("learner")
            if self.an.drain_ingest:
                # rows of actors on another host, if any, land in ring 0
                t0 = time.perf_counter()
                fed = memory.drain()
                if fed:
                    self._fill[0] = min(self._fill[0] + fed,
                                        self.rings[0].capacity)
                spent["drain"] += time.perf_counter() - t0
            prev = self.lstep
            if self.want_rollout():
                self.dispatch_rollout()
            else:
                self.dispatch_learn()
            crossed = lambda freq: freq and \
                self.lstep // freq != prev // freq
            t0 = time.perf_counter()
            if crossed(ap.param_publish_freq):
                if self.publisher is not None:
                    self.publisher.submit(self.state.params)
                else:
                    self.publish_inline()
            spent["publish"] += time.perf_counter() - t0
            if crossed(ap.checkpoint_freq):
                self.save_epoch()
            if crossed(ap.learner_freq):
                now = time.monotonic()
                self._stats_line(now, t_window, window_lstep)
                t_window, window_lstep = now, self.lstep
        if self.cuda:
            torch.cuda.synchronize(self.device)
        seconds = time.monotonic() - t_start
        self._fold_pending()
        self._window_times()  # the last window into the totals
        published = 0
        if self.publisher is not None:
            self.publisher.close()
            published = self.publisher.published
        self.publish_inline()  # the finished weights
        self.save_epoch()  # the final epoch, also on a preemption
        self.flush_actor_stats()
        self.writer.close()
        return self.summary(seconds, clock.actor_step.value - actor_step0,
                            spent, published)

    def summary(self, seconds: float, actor_steps: float, spent: dict,
                published: int) -> Dict[str, float]:
        busy = self.totals["rollout"] + self.totals["learn"]
        out = {k: float(v) for k, v in self._last_metrics.items()}
        out.update({
            "learner/steps": self.lstep,
            "learner/updates_per_sec": (self.lstep - self.lstep_resumed)
            / max(seconds, 1e-9),
            "learner/resumed_from_step": self.lstep_resumed,
            "learner/train_seconds": seconds,
            SKIPPED_KEY: float(self._skipped),
            "learner/host_s_drain": spent["drain"],
            "learner/host_s_publish": spent["publish"],
            "learner/async_publishes": published,
            "checkpoint/epochs_committed": self.saver.epochs,
            "checkpoint/save_seconds": self.saver.seconds,
            "checkpoint/epoch_bytes": self.saver.bytes,
            "replay/restored_rows": self.restored_rows,
            "replay/size": self.memory.size,
            "actor/steps": self.clock.actor_step.value,
            "actor/steps_per_sec": actor_steps / max(seconds, 1e-9),
            "anakin/rollouts": self.counts["rollouts"],
            "anakin/learns": self.counts["learns"],
            "anakin/frames": self.frames,
            "anakin/duty_cycle": (self.totals["rollout"] / busy
                                  if busy > 0 else 0.0),
            # device seconds on a GPU (CUDA events), host seconds on the CPU
            "anakin/rollout_s": self.totals["rollout"],
            "anakin/learn_s": self.totals["learn"],
            "anakin/replay_fill": self.replay_fill(),
        })
        return out


def run_anakin_learner(opt: Options, spec, process_ind: int, memory: Any,
                       param_store, clock, stats=None,
                       actor_stats=None) -> Dict[str, float]:
    """The learner's process under ``actor_backend=anakin``: this loop is
    the actor fleet and the learner.  Returns the run's summary."""
    return AnakinDriver(opt, spec, memory, param_store, clock, stats,
                        actor_stats=actor_stats,
                        process_ind=process_ind).run()
