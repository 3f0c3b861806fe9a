"""The learner loop — the port of pytorch_distributed_tpu/agents/learner.py
``run_learner`` (:56-, :166-204, :264-351, :455-485, :474-760, :907-916),
its device branch (the ``device-per`` and ``device`` rings, with or
without megabatch) and its host branch (``shared``, ``native`` and
``prioritized``, :680-760): resume from the newest complete checkpoint
epoch unless ``resume`` is "never" (the state, the actors' step count
added to the clock, the best evaluation, the pacing baseline, the device
generator and, with ``checkpoint_replay``, the ring; the host generator on
a host ring), publish the initial weights, wait for ``learn_start`` rows,
then loop until ``steps``:

- ``max_replay_ratio`` pacing (keep draining while throttled, so a full
  ingest queue never blocks the actors that advance the clock);
- drain the ingest queue into the ring;
- on a device ring, one fused dispatch of K = ``steps_per_dispatch``
  sub-steps of sample -> train (-> priority write-back on the PER ring;
  memory/device_per.py, memory/device_replay.py), on uniforms drawn from
  the learner's device generator; on a GPU it is replayed from a CUDA
  graph.  With ``megabatch`` M > 1 (``factory.resolve_fused_step``) K is
  rounded up to a multiple of M and the dispatch runs K/M group steps;
- on a host ring, one update: a batch drawn on the host with the
  learner's numpy generator, uploaded through pinned memory with
  non-blocking copies, the train step, and on the PER ring the |TD|
  written back unless the guard skipped the update.  Megabatch does not
  apply there (the reference's line says so and the run goes on
  unbatched);
- beta annealed on the dispatch cadence (device PER);
- a published snapshot every ``param_publish_freq`` steps (on a GPU
  through ``DevicePublisher``, off the loop, as the reference's
  ``_publish_async`` :223-263; on the CPU inline), and on every
  ``learner_freq`` steps a stats line and one ``LearnerStats`` add (the
  window's last losses and its updates/s, reference :757), all on
  boundary crossings so K > 1 never skips one;
- a checkpoint epoch on every ``checkpoint_freq`` crossing;
- a liveness mark on the clock's progress board on every loop and every
  pacing wait, which the runtime's hang watchdog reads;
- a final synchronous publication, which the evaluator's last evaluation
  and the params checkpoint read, and then a final checkpoint epoch.  A
  SIGTERM (runtime.py) stops the loop early and lands here too.

With ``--model-file`` in mode 1 the initial params are the file's
(fine-tuning, reference :113-118), before any resume.

The health sentinel (``HealthSentinel``, reference :553-630, :770-870)
watches the stats windows: the window's skipped steps (the device count's
difference, read where the metrics are read), the window's last loss and
grad norm and the PER X-ray of the ring (``priority_xray_device``, one
small copy to the host) go to ``health.AnomalyDetector``, and
``health/*`` and ``replay/priority_ess*`` rows to ``scalars.jsonl``.  A
streak of ``anomaly_threshold`` anomalous windows rolls the learner back
in process: to the newest complete epoch older than the previous restore
point, with every newer epoch fenced, the train state, the ring (with
``checkpoint_replay``), the device generator and the learner step
restored and the actors' step count left as it is; after
``max_rollbacks`` rollbacks, or with no epoch to go back to, the learner
raises ``RuntimeError("[health] ...")``.  ``LEARNER_FAULTS`` counts one
frame per dispatch; its ``poison_grad`` NaNs the rewards of the next
host-sampled batch (the guard then skips that update, reference
:699-709) and stays inert on the fused device path, with the reference's
notice (:662-667).  The X-ray is the device ring's, the host PER ring's
leaves (``health.priority_xray``), or none on a uniform ring.

On a GPU the resume comes before the CUDA graph's capture, which clones
its static buffers from the state it is first handed, and an epoch reads
the state from those buffers after a synchronize, so no replay is in
flight while it is copied out.  A rollback hands the graph the restored
state, which its call copies into the static buffers, and restores the
ring in place, so the graph replays on the restored tensors.

Returns a summary of the run (steps, this run's updates per second, the
last metrics, the skipped-step count, the host seconds spent pacing,
draining, dispatching and publishing, the actors' env steps over the
loop, the step it resumed from, the epochs it committed, the rollbacks
and the ingest's validation counts), which ``main`` prints.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch.agents.clocks import (
    GlobalClock, LearnerStats,
)
from pytorch_distributed_tpu_torch.agents.param_store import (
    DevicePublisher, ParamStore, flatten_into,
)
from pytorch_distributed_tpu_torch.config import Options
from pytorch_distributed_tpu_torch.factory import (
    EnvSpec, anakin_active, build_model, build_train_state_and_step,
    init_params, resolve_device, resolve_fused_step, role_seed,
)
from pytorch_distributed_tpu_torch.memory.device_per import GraphedFusedStep
from pytorch_distributed_tpu_torch.memory.device_replay import (
    DeviceReplayIngest,
)
from pytorch_distributed_tpu_torch.ops.cuda_sampling import (
    hierarchical_sample,
)
from pytorch_distributed_tpu_torch.ops.cuda_torso import (
    COUNTERS as GEMM_COUNTERS,
)
from pytorch_distributed_tpu_torch.ops.losses import SKIPPED_KEY, TrainState
from pytorch_distributed_tpu_torch.utils import checkpoint as ckpt
from pytorch_distributed_tpu_torch.utils import flight_recorder, health
from pytorch_distributed_tpu_torch.utils.faults import FaultInjector
from pytorch_distributed_tpu_torch.utils.experience import Batch
from pytorch_distributed_tpu_torch.utils.metrics import MetricsWriter
from pytorch_distributed_tpu_torch.utils.perf import resolve_mxu


def initial_params(opt: Options, spec: EnvSpec,
                   device) -> Dict[str, torch.Tensor]:
    """The params a run starts from: ``init_params`` from the seed, or the
    ``model_file``'s (``models/{refs}`` or a ``.pt`` path) when one is
    given, as the reference fine-tunes (learner.py:113-118,
    anakin.py:166-171).  A resume then replaces them with an epoch's."""
    params = init_params(opt, spec, seed=opt.seed, device=device)
    path = opt.model_file
    if not path:
        return params
    if path.endswith(".msgpack"):
        raise ValueError(
            f"{path} is a params file of the JAX package: convert its param "
            f"tree with pytorch_distributed_tpu_torch.convert.convert_dqn_cnn "
            f"and write it with utils.checkpoint.save_params first")
    if not path.endswith(ckpt.EXT):
        path = ckpt.params_path(path)
    loaded = ckpt.load_params(path)
    wrong = sorted(k for k in params.keys() | loaded.keys()
                   if k not in loaded or k not in params
                   or loaded[k].shape != params[k].shape)
    if wrong:
        raise ValueError(f"{path} does not fit the model: {wrong}")
    print(f"[learner] initial params from {path}", flush=True)
    return {k: loaded[k].to(device=device, dtype=v.dtype)
            for k, v in params.items()}


def resume_epoch(opt: Options) -> Optional[ckpt.EpochInfo]:
    """The epoch a run resumes from: the newest complete one unless
    ``resume`` is "never"; "must" raises without one."""
    if opt.resume not in ("auto", "must", "never"):
        raise ValueError(f"unknown resume mode {opt.resume!r}")
    if opt.resume == "never":
        return None
    epoch = ckpt.resolve_epoch(opt.model_name)
    if epoch is None and opt.resume == "must":
        raise RuntimeError(f"resume='must' but no complete checkpoint "
                           f"epoch under {ckpt.ckpt_root(opt.model_name)}")
    return epoch


def epoch_extras(clock: GlobalClock, lstep: int, lstep0: int,
                 replay_size: int, gen: torch.Generator,
                 host_rng: Optional[np.random.Generator] = None) -> dict:
    """What an epoch records beside the state (reference :526-552); the
    host generator too on a host ring."""
    rng = dict(learner_device=ckpt.serialize_torch_rng(gen))
    if host_rng is not None:
        rng["learner_host"] = ckpt.serialize_np_rng(host_rng)
    return dict(
        learner_step=lstep,
        lstep0=lstep0,
        actor_step=int(clock.actor_step.value),
        best_eval_reward=float(clock.best_eval_reward.value),
        replay_size=replay_size,
        rollbacks=int(clock.rollbacks.value),
        skipped_steps=int(clock.skipped_steps.value),
        rng=rng)


def restore_epoch(opt: Options, epoch: ckpt.EpochInfo, clock: GlobalClock,
                  device, role: str = "learner") -> TrainState:
    """The epoch's train state on ``device``; the clock takes the epoch's
    actor steps (added) and the best evaluation (the epoch's or the
    ``_best`` sidecar's, whichever is higher)."""
    state = ckpt.load_epoch_state(epoch, device)
    clock.seed_actor_steps(int(epoch.extras.get("actor_step", 0)))
    # the sidecar can be ahead of the epoch's score when a record fell
    # between two commits
    best = max(float(epoch.extras.get("best_eval_reward", float("-inf"))),
               ckpt.load_best_score(opt.model_name))
    clock.best_eval_reward.value = best
    print(f"[{role}] resumed epoch {epoch.epoch} "
          f"(step {epoch.learner_step}, "
          f"actor_step +{int(epoch.extras.get('actor_step', 0))}, "
          f"best_eval {best:g})", flush=True)
    return state


class EpochSaver:
    """Commits checkpoint epochs of one learner (with the ring when
    ``checkpoint_replay``) and counts them: ``epochs``, ``seconds`` and the
    newest epoch's ``bytes``.  On a GPU it synchronizes first, so no
    replay of a graph is in flight while the state is copied out."""

    def __init__(self, opt: Options, clock: GlobalClock, memory, device,
                 host_rng: Optional[np.random.Generator] = None):
        self.opt, self.clock, self.memory = opt, clock, memory
        self.device = torch.device(device)
        self.host_rng = host_rng
        self.epochs, self.seconds, self.bytes = 0, 0.0, 0
        self._skipped = 0

    def count_skipped(self, skipped: torch.Tensor) -> int:
        """Bring the clock's ``skipped_steps`` up to the device's running
        count (a read that waits for the device); returns the count."""
        n = int(skipped)
        self.clock.add_skipped_steps(n - self._skipped)
        self._skipped = n
        return n

    def save(self, state: TrainState, lstep: int, lstep0: int,
             gen: torch.Generator, skipped: torch.Tensor) -> None:
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.count_skipped(skipped)
        opt = self.opt
        path = ckpt.save_epoch(
            opt.model_name, state=state,
            memory=(self.memory if opt.memory_params.checkpoint_replay
                    else None),
            extras=epoch_extras(self.clock, lstep, lstep0, self.memory.size,
                                gen, self.host_rng),
            retain=opt.agent_params.checkpoint_retain)
        self.epochs += 1
        self.seconds += time.perf_counter() - t0
        self.bytes = ckpt.epoch_bytes(path)
        self.clock.bump_progress("learner")


class HealthSentinel:
    """The learner's half of the health plane: the anomaly detector on the
    stats windows and the rollback ladder (reference agents/learner.py
    :553-630, :770-870), with the ``learner`` flight recorder."""

    def __init__(self, opt: Options, clock: GlobalClock, memory, device):
        self.opt, self.clock, self.memory = opt, clock, memory
        self.device = device
        self.hp = hp = health.resolve(opt.health_params)
        self.detector = health.AnomalyDetector(
            zmax=hp.anomaly_zmax, grad_spike=hp.grad_spike,
            threshold=hp.anomaly_threshold, ess_floor=hp.ess_floor)
        self.recorder = flight_recorder.get_recorder("learner")
        self.writer = MetricsWriter(opt.log_dir, role="learner",
                                    run_id=opt.refs)
        self.used = 0          # rollbacks spent
        self.before = None     # the ladder's last restore point
        self._win_base = 0     # the skipped count at the window's start
        self.xrays, self.xray_s, self.rollback_s = 0, 0.0, 0.0

    def window(self, lstep: int, vals: Dict[str, float],
               skipped: int, td_mean: Optional[float] = None
               ) -> Optional[str]:
        """One stats window: ``vals`` are the window's last metrics,
        ``skipped`` the running skipped count and ``td_mean`` the last
        host write-back's mean |TD| (host PER).  Feeds the detector, writes
        the health rows; returns the reason when a rollback is due."""
        skipped_w = skipped - self._win_base
        self._win_base = skipped
        t0 = time.perf_counter()
        xr = self.memory.xray()
        if xr is not None:
            self.xrays += 1
            self.xray_s += time.perf_counter() - t0
        else:
            xr = {"rows": 0, "mass": None, "ess_frac": None}
        anomalies = self.detector.observe(
            loss=vals.get("learner/critic_loss"),
            grad_norm=vals.get("learner/grad_norm"), td_mean=td_mean,
            priority_mass=xr["mass"], replay_rows=xr["rows"],
            skipped=skipped_w, priority_ess=xr["ess_frac"])
        det = self.detector
        if anomalies:
            self.recorder.record("anomaly", step=lstep, kinds=anomalies,
                                 streak=det.streak)
            print(f"[health] anomaly at step {lstep}: "
                  f"{'+'.join(anomalies)} (streak {det.streak}/"
                  f"{self.hp.anomaly_threshold})", flush=True)
        rows = {"health/skipped_steps": float(self.clock.skipped_steps.value),
                "health/rollbacks": float(self.clock.rollbacks.value),
                "health/anomaly_streak": float(det.streak)}
        if xr["rows"]:
            rows.update({"replay/priority_ess": xr["ess"],
                         "replay/priority_ess_frac": xr["ess_frac"]})
        self.writer.scalars(rows, step=lstep)
        if self.hp.rollback and det.should_rollback():
            return "+".join(anomalies) or "anomaly streak"
        return None

    def _fatal(self, lstep: int, msg: str) -> None:
        self.recorder.record("divergence-fatal", step=lstep, detail=msg)
        flight_recorder.dump_all(f"learner divergence: {msg}")
        self.close()
        raise RuntimeError(f"[health] {msg}")

    def rollback(self, reason: str, lstep: int, gen: torch.Generator,
                 skipped: int,
                 host_rng: Optional[np.random.Generator] = None
                 ) -> Tuple[TrainState, int, int]:
        """Restore the newest complete epoch older than the last restore
        point and fence every newer one: ``(state, lstep, lstep0)``, with
        the ring (under ``checkpoint_replay``) and ``gen`` restored in
        place and the clock's learner step and rollback count set.
        ``skipped`` is the running skipped count, which the next window
        starts from.  Raises past ``max_rollbacks`` or with no epoch."""
        opt, hp = self.opt, self.hp
        if self.used >= hp.max_rollbacks:
            self._fatal(lstep, f"divergence persists after {self.used} "
                               f"rollback(s) (max_rollbacks="
                               f"{hp.max_rollbacks}): {reason}")
        t0 = time.perf_counter()
        target = ckpt.resolve_epoch(opt.model_name, before=self.before)
        if target is None:
            self._fatal(lstep, f"sustained divergence ({reason}) with no "
                               f"checkpoint epoch to roll back to")
        ckpt.fence_epochs_after(opt.model_name, target.epoch, reason=reason)
        state = ckpt.load_epoch_state(target, self.device)
        if opt.memory_params.checkpoint_replay and target.has_replay:
            rows = ckpt.load_epoch_replay(target, self.memory)
            print(f"[health] replay rolled back with the epoch: {rows} rows",
                  flush=True)
        lstep = (target.learner_step if target.learner_step >= 0
                 else int(state.step))
        lstep0 = int(target.extras.get("lstep0", lstep))
        rng = target.extras.get("rng", {})
        ckpt.restore_torch_rng(gen, rng.get("learner_device"))
        if host_rng is not None:
            ckpt.restore_np_rng(host_rng, rng.get("learner_host"))
        self.clock.set_learner_step(lstep)
        with self.clock.rollbacks.get_lock():
            self.clock.rollbacks.value += 1
        self.used += 1
        self.before = target.epoch
        self.detector.reset()
        self._win_base = skipped  # the dead tail's skips start no streak
        self.rollback_s += time.perf_counter() - t0
        self.recorder.record("rollback", epoch=target.epoch, step=lstep,
                             reason=reason, used=self.used)
        flight_recorder.dump_all(f"health rollback #{self.used} to epoch "
                                 f"{target.epoch} ({reason})")
        print(f"[health] rolled back to epoch {target.epoch} (step {lstep}) "
              f"after {reason}; {hp.max_rollbacks - self.used} rollback(s) "
              f"left", flush=True)
        return state, lstep, lstep0

    def close(self) -> None:
        self.writer.close()


def upload_batch(batch: Batch, device) -> Batch:
    """A host batch (numpy columns) on ``device``: on a GPU each column is
    staged through pinned memory and copied without blocking, in order on
    the current stream, before the update that reads it."""
    cols = [torch.from_numpy(np.ascontiguousarray(c)) for c in batch]
    if torch.device(device).type == "cuda":
        return Batch(*(c.pin_memory().to(device, non_blocking=True)
                       for c in cols))
    return Batch(*cols)


def run_learner(opt: Options, spec: EnvSpec, process_ind: int,
                memory, param_store: ParamStore,
                clock: GlobalClock,
                stats: Optional[LearnerStats] = None) -> Dict[str, float]:
    if anakin_active(opt):
        # this process is the actor fleet too (reference :56-72); the
        # runtime calls run_anakin_learner itself, to hand it the ActorStats
        from pytorch_distributed_tpu_torch.agents.anakin import (
            run_anakin_learner,
        )

        return run_anakin_learner(opt, spec, process_ind, memory,
                                  param_store, clock, stats)
    ap = opt.agent_params
    device = resolve_device(opt)
    model = build_model(opt, spec)
    params = initial_params(opt, spec, device)
    state, step_fn = build_train_state_and_step(opt, model, params)
    host_flat = torch.empty(param_store.num_params)
    on_device = isinstance(memory, DeviceReplayIngest)
    is_device_per = on_device and memory.prioritized
    is_per = not on_device and memory.prioritized  # the host PER ring
    if not on_device:
        m_req = resolve_mxu(opt.learner_perf_params).megabatch
        if m_req > 1:  # reference :287-300
            print(f"[learner] megabatch={m_req} requires a device replay "
                  f"(memory_type device/device-per; got {opt.memory_type}); "
                  f"host-path learner runs unbatched", flush=True)

    # the counters come back before the first publication, so no worker
    # sees the values from before the resume
    epoch = resume_epoch(opt)
    t_restore = time.perf_counter()
    if epoch is not None:
        state = restore_epoch(opt, epoch, clock, device)

    def publish_inline(p) -> None:
        flatten_into({k: v.detach().cpu() for k, v in p.items()}, host_flat,
                     spec.state_shape)
        param_store.publish(host_flat.numpy())

    publish_inline(state.params)  # actors block on version 1
    publisher = (DevicePublisher(param_store, spec.state_shape, device)
                 if device.type == "cuda" else None)

    replay = memory.attach(device) if on_device else None
    restored_rows = 0
    if epoch is not None and opt.memory_params.checkpoint_replay:
        # the ring from the same epoch as the state, never a mix; a
        # changed geometry raises CheckpointMismatch here
        restored_rows = ckpt.load_epoch_replay(epoch, memory)
        if restored_rows:
            print(f"[learner] replay restored from epoch {epoch.epoch}: "
                  f"{restored_rows} rows", flush=True)
    restore_s = time.perf_counter() - t_restore if epoch is not None \
        else 0.0
    host_rng = None
    if on_device:
        M, K, mega_step = resolve_fused_step(opt, model, "learner")
        fused = replay.build_fused_step(step_fn, ap.batch_size,
                                        steps_per_call=K, megabatch=M,
                                        megabatch_step=mega_step)
        if device.type == "cuda":
            fused = GraphedFusedStep(fused, replay.state,
                                     counters=(hierarchical_sample,
                                               *GEMM_COUNTERS))
    else:
        K = 1
        host_rng = np.random.default_rng(
            role_seed(opt.seed, "learner_host", process_ind))
    gen = torch.Generator(device=device).manual_seed(
        role_seed(opt.seed, "learner", process_ind))
    lstep = lstep0 = int(state.step)
    if epoch is not None:
        # pacing goes on from the epoch's baseline against the restored
        # actor count, and the draws from where the epoch froze them
        lstep0 = int(epoch.extras.get("lstep0", lstep0))
        rng = epoch.extras.get("rng", {})
        ckpt.restore_torch_rng(gen, rng.get("learner_device"))
        if host_rng is not None:
            ckpt.restore_np_rng(host_rng, rng.get("learner_host"))
    lstep_resumed = lstep
    clock.set_learner_step(lstep)
    saver = EpochSaver(opt, clock, memory, device, host_rng)
    sentinel = HealthSentinel(opt, clock, memory, device)
    faults = FaultInjector.from_env("learner")

    # gate until the replay warms up; clamped below the ring's capacity,
    # whose fill never exceeds it
    learn_start = min(ap.learn_start, memory.capacity - 1)
    deadline = (time.monotonic() + ap.max_seconds) if ap.max_seconds > 0 \
        else float("inf")
    while not clock.done(ap.steps) and time.monotonic() < deadline:
        clock.bump_progress("learner")  # a warm-up is no hang
        memory.drain()
        if memory.size > learn_start:
            break
        time.sleep(0.01)

    metrics: Dict[str, torch.Tensor] = {}
    skipped = torch.zeros((), device=device)
    beta, next_beta = (replay.beta(0) if is_device_per else None), 0
    poison = False
    td_mean: Optional[float] = None  # the last host PER write-back's
    t_start = t_window = time.monotonic()
    window_lstep = lstep
    updates = 0  # dispatched, rolled-back ones included
    actor_step0 = clock.actor_step.value
    spent = dict.fromkeys(("pacing", "drain", "step", "publish"), 0.0)
    while lstep < ap.steps and not clock.stop.is_set() \
            and time.monotonic() < deadline:
        t0 = time.perf_counter()
        clock.bump_progress("learner")
        if faults.data_frame(("poison_grad",)):
            poison = True
        if ap.max_replay_ratio > 0:
            while (not clock.stop.is_set() and time.monotonic() < deadline
                   and (lstep - lstep0 + 1) * ap.batch_size
                   > ap.max_replay_ratio * max(clock.actor_step.value, 1)):
                memory.drain()
                clock.bump_progress("learner")  # pacing is no hang
                time.sleep(0.002)
            if clock.stop.is_set():
                break
        t1 = time.perf_counter()
        memory.drain()
        t2 = time.perf_counter()
        if on_device:
            if poison:
                poison = False
                print("[faults:learner] poison_grad targets the "
                      "host-sampled batch; inert on the fused device path "
                      "(drill with poison_chunk instead)", flush=True)
            if is_device_per and lstep >= next_beta:
                # beta anneals slowly: refresh every 64 K
                beta, next_beta = replay.beta(lstep), lstep + 64 * K
            us = torch.rand((K, ap.batch_size), generator=gen, device=device)
            state, metrics = fused(state, replay.state, us, beta)
        else:
            batch = memory.sample(ap.batch_size, host_rng)
            if poison:
                # the guard must skip this update, params unchanged
                poison = False
                batch = batch._replace(reward=np.full_like(
                    np.asarray(batch.reward), np.nan))
                print("[faults:learner] poison_grad: NaN rewards injected "
                      "into this update's batch", flush=True)
            state, metrics, td_abs = step_fn(state,
                                             upload_batch(batch, device))
            if is_per:
                # the write-back needs |TD| on the host now, and the skip
                # flag rides the same copy
                sk = metrics.get(SKIPPED_KEY)
                host = torch.cat([td_abs.float(), (
                    sk if sk is not None else torch.zeros(
                        (), device=td_abs.device)).view(1)]).cpu().numpy()
                if host[-1] < 0.5:
                    td_mean = float(np.mean(host[:-1]))
                    memory.update_priorities(np.asarray(batch.index),
                                             host[:-1])
        skipped = skipped + metrics.get(SKIPPED_KEY, 0.0)
        updates += K
        prev, lstep = lstep, lstep + K
        clock.set_learner_step(lstep)
        t3 = time.perf_counter()

        crossed = lambda freq: freq and lstep // freq != prev // freq
        if crossed(ap.param_publish_freq):
            if publisher is not None:
                publisher.submit(state.params)
            else:
                publish_inline(state.params)
        t4 = time.perf_counter()
        for key, dt in zip(spent, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            spent[key] += dt
        if crossed(ap.checkpoint_freq):
            saver.save(state, lstep, lstep0, gen, skipped)
        if crossed(ap.learner_freq):
            now = time.monotonic()
            vals = {k: float(v) for k, v in metrics.items()}
            rate = (lstep - window_lstep) / max(now - t_window, 1e-9)
            print(f"[learner] step {lstep} "
                  f"loss {vals['learner/critic_loss']:.5g} "
                  f"q_mean {vals['learner/q_mean']:.5g} "
                  f"{rate:.1f} updates/s replay {memory.size}", flush=True)
            if stats is not None:  # reference learner.py:757-766
                stats.add(counter=1,
                          critic_loss=vals.get("learner/critic_loss", 0.0),
                          q_mean=vals.get("learner/q_mean", 0.0),
                          grad_norm=vals.get("learner/grad_norm", 0.0),
                          steps_per_sec=rate)
            n_skipped = saver.count_skipped(skipped)
            reason = sentinel.window(lstep, vals, n_skipped, td_mean)
            if reason is not None:
                state, lstep, lstep0 = sentinel.rollback(
                    reason, lstep, gen, n_skipped, host_rng)
                next_beta = lstep  # beta follows the restored step
            t_window, window_lstep = now, lstep
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.monotonic() - t_start
    actor_steps = clock.actor_step.value - actor_step0
    published = 0
    if publisher is not None:
        publisher.close()
        published = publisher.published
    publish_inline(state.params)  # the finished weights
    # the final epoch, also on a preemption: a next run resumes from it
    saver.save(state, lstep, lstep0, gen, skipped)
    sentinel.close()
    summary = {k: float(v) for k, v in metrics.items()}
    summary.update({
        "learner/steps": lstep,
        "learner/updates": updates,
        "learner/updates_per_sec": updates / max(seconds, 1e-9),
        "learner/resumed_from_step": lstep_resumed,
        "checkpoint/epochs_committed": saver.epochs,
        "checkpoint/save_seconds": saver.seconds,
        "checkpoint/epoch_bytes": saver.bytes,
        "checkpoint/restore_seconds": restore_s,
        "replay/restored_rows": restored_rows,
        "learner/train_seconds": seconds,
        SKIPPED_KEY: float(skipped),
        "health/rollbacks": clock.rollbacks.value,
        "health/rollback_seconds": sentinel.rollback_s,
        "health/xrays": sentinel.xrays,
        "health/xray_seconds": sentinel.xray_s,
        "ingest/validated": memory.validated,
        "ingest/quarantined": memory.quarantined,
        "ingest/validate_seconds": memory.validate_s,
        **{f"learner/host_s_{k}": v for k, v in spent.items()},
        "learner/async_publishes": published,
        "replay/size": memory.size,
        "actor/steps": clock.actor_step.value,
        "actor/steps_per_sec": actor_steps / max(seconds, 1e-9),
    })
    return summary
