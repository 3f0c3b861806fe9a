"""The learner loop — the port of pytorch_distributed_tpu/agents/learner.py
``run_learner`` (:56-, :72-94, :166-204, :264-351, :455-485, :474-760, :907-916),
its device branch (the ``device-per`` and ``device`` rings, with or
without megabatch, and the ``device-sequence`` segment ring, whose ingest
has the PER ring's surface, :266-270) and its host branch (``shared``,
``native``, ``prioritized`` and the ``sequence`` segment ring,
:680-760), for the dqn, DDPG and r2d2 families (the step
is the factory's; what is published and checkpointed as params is the
model's whole state dict, ``factory.published_params``, merged back from
the decoupled DDPG state's two nets): resume from the newest complete
checkpoint epoch unless ``resume`` is "never" (the state, the actors' step
count added to the clock, the best evaluation, the pacing baseline, the
device generator and, with ``checkpoint_replay``, the ring; the host
generator on a host ring), publish the initial weights, wait for
``learn_start`` rows, then loop until ``steps``:

- ``max_replay_ratio`` pacing (keep draining while throttled, so a full
  ingest queue never blocks the actors that advance the clock);
- drain the ingest queue into the ring;
- on a device ring, one fused dispatch of K = ``steps_per_dispatch``
  sub-steps of sample -> train (-> priority write-back on the PER ring;
  memory/device_per.py, memory/device_replay.py), on uniforms drawn from
  the learner's device generator; on a GPU it is replayed from a CUDA
  graph.  With ``megabatch`` M > 1 (``factory.resolve_fused_step``) K is
  rounded up to a multiple of M and the dispatch runs K/M group steps;
- ``learn_start`` counts segments on a segment ring, and is clamped
  below the ring's capacity on every ring (reference :489);
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

The data plane (``DataXray``, reference :515-525, :687-710, :775-846,
:896-901) rides the same windows: the provenance of what the learner
trains on (the last host batch's rows through the ring's
``provenance_of``, or 256 rows drawn from a device ring's ``prov``
column, one small copy) through ``health.provenance_stats`` as the
``learner/staleness``, ``learner/sample_age`` and ``replay/actor_share``
histogram rows; the X-ray's ``replay/priority`` bucket row; the
bandwidth X-ray's ``wire/*`` and ``replay/hbm_bytes`` rows; and the
``learner`` and ``feeder`` tracers' span rows.  Each dispatch records a
``learn`` span and each host draw a ``sample`` span against the newest
trace id the drain saw.

The perf plane (utils/perf.py, off by default; reference :273-286,
:383-413, :739, :805-810, :847, :871-894, :636-637, :917-919): the
``learner`` monitor takes the compute dtype, and on a device ring the
FLOPs of one update (``factory.update_flops``) and the fused step's
graph for the recapture detector; with ``transfer_audit`` each dispatch
runs under ``TransferAudit``.  Every dispatch counts its K updates; each
stats window sets the ``data/staleness_p50``, ``data/sample_age_p95``,
``data/top_actor_share`` and ``data/priority_ess`` gauges (DataXray),
``learner/replay_ratio`` and the ingest queue's depth and use, then
drains the monitor into ``scalars.jsonl``, as the loop's entry (the
anchor) and its end (the last partial window) do.  The loop holds the
profile windows (``profiling.hold_windows``): one asked for from another
thread (``perf.run_profile_window``) opens and closes in the learner's
thread, between two dispatches or pacing waits.

On a GPU the resume comes before the CUDA graph's capture, which clones
its static buffers from the state it is first handed, and an epoch reads
the state from those buffers after a synchronize, so no replay is in
flight while it is copied out.  A rollback hands the graph the restored
state, which its call copies into the static buffers, and restores the
ring in place, so the graph replays on the restored tensors.

With ``replicas`` > 1 on a fleet's learner host (``dcn.local_registry``)
or with a ``coordinator``, the dqn family's learner is a replica of the
replica plane (``run_replica_learner`` below, reference :72-94,
:945-1381).

Returns a summary of the run (steps, this run's updates per second, the
last metrics, the skipped-step count, the host seconds spent pacing,
draining, dispatching and publishing, the actors' env steps over the
loop, the step it resumed from, the epochs it committed, the rollbacks
and the ingest's validation counts), which ``main`` prints.
"""

from __future__ import annotations

import hashlib
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
    compute_dtype, init_params, published_params, resolve_device,
    resolve_fused_step, role_seed, update_flops,
)
from pytorch_distributed_tpu_torch.memory.device_per import GraphedFusedStep
from pytorch_distributed_tpu_torch.memory.device_replay import (
    DeviceReplayIngest, provenance_sample,
)
from pytorch_distributed_tpu_torch.memory.device_sequence import (
    DeviceSequenceIngest,
)
from pytorch_distributed_tpu_torch.ops.cuda_sampling import (
    hierarchical_sample,
)
from pytorch_distributed_tpu_torch.ops.cuda_torso import (
    COUNTERS as GEMM_COUNTERS,
)
from pytorch_distributed_tpu_torch.ops.losses import SKIPPED_KEY, TrainState
from pytorch_distributed_tpu_torch.utils import checkpoint as ckpt
from pytorch_distributed_tpu_torch.utils import (
    bandwidth, flight_recorder, health, perf, profiling, tracing,
)
from pytorch_distributed_tpu_torch.utils.faults import FaultInjector
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
        self.writer = MetricsWriter(opt.log_dir, enable_tensorboard=False,
                                    role="learner", run_id=opt.refs)
        self.last_xray: Optional[dict] = None  # the window's X-ray
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
        xr = self.last_xray = self.memory.xray()
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


class DataXray:
    """The learner's data plane on its stats windows (see the module
    docstring), written through ``writer``."""

    PROV_SAMPLE = 256  # rows of a device ring's provenance read a window

    def __init__(self, opt: Options, memory, param_store, writer):
        self.memory, self.param_store = memory, param_store
        self.writer = writer
        self.perf = perf.get_monitor("learner", opt.perf_params)
        self.on_device = isinstance(memory, DeviceReplayIngest)  # has prov
        # the provenance draw's own generator: the learner's draws stay as
        # they are
        self.rng = np.random.default_rng(role_seed(opt.seed, "telemetry", 0))
        self.tracer = tracing.get_tracer("learner")

    def provenance(self, last_idx) -> Optional[np.ndarray]:
        fn = getattr(self.memory, "provenance_of", None)
        if fn is not None and last_idx is not None:
            prov = fn(last_idx)
            return None if prov is None else np.asarray(prov)
        if self.on_device:
            return provenance_sample(self.memory.replay.state, self.rng,
                                     self.PROV_SAMPLE)[0]
        return None

    def window(self, lstep: int, last_idx=None,
               xray: Optional[dict] = None) -> None:
        w = self.writer
        prov = self.provenance(last_idx)
        ds = (health.provenance_stats(prov, self.param_store.version, lstep)
              if prov is not None else None)
        if ds is not None:
            w.histogram("learner/staleness", ds["staleness"].tolist(),
                        step=lstep)
            w.histogram("learner/sample_age", ds["age"].tolist(), step=lstep)
            w.histogram("replay/actor_share", ds["shares"].tolist(),
                        step=lstep)
            self.perf.set_gauge("data/staleness_p50",
                                float(np.median(ds["staleness"])))
            self.perf.set_gauge("data/sample_age_p95",
                                float(np.percentile(ds["age"], 95)))
            self.perf.set_gauge("data/top_actor_share",
                                float(ds["shares"].max()))
        if xray is not None and xray.get("rows"):
            w.bucket_histogram(
                "replay/priority", xray["counts"],
                log10_lo=health.PRIORITY_XRAY_LOG10_LO,
                log10_hi=health.PRIORITY_XRAY_LOG10_HI, step=lstep,
                extra={"ess": xray["ess"], "ess_frac": xray["ess_frac"],
                       "mass": xray["mass"], "rows": xray["rows"]})
            self.perf.set_gauge("data/priority_ess", xray["ess_frac"])
        wire = bandwidth.emit_scalars()
        if wire:
            w.scalars(wire, step=lstep)
        self.flush_traces(lstep)

    def flush_traces(self, lstep: int) -> None:
        for t in (self.tracer, tracing.get_tracer("feeder")):
            t.flush_to(self.writer, step=lstep)


def drain_perf(mon, writer, memory, clock: GlobalClock, lstep: int,
               lstep0: int, batch_size: int) -> None:
    """The learner's gauges the monitor cannot see (reference :871-894):
    the replay ratio over this run's steps, the ingest queue's depth and
    use (1.0: the actors wait on it); then the window's drain."""
    mon.set_gauge("learner/replay_ratio", (lstep - lstep0) * batch_size
                  / max(int(clock.actor_step.value), 1))
    depth_fn = getattr(memory, "queue_depth", None)
    depth = depth_fn() if depth_fn is not None else None
    if depth is not None:
        mon.set_gauge("learner/ingest_queue_depth", depth)
        if memory.max_queue_chunks:
            mon.set_gauge("learner/ingest_queue_util",
                          depth / memory.max_queue_chunks)
    writer.scalars(mon.drain(step=lstep), step=lstep)


def upload_batch(batch, device):
    """A host batch (a ``Batch`` or a ``SegmentBatch`` of numpy columns) on
    ``device``: on a GPU each column is staged through pinned memory and
    copied without blocking, in order on the current stream, before the
    update that reads it."""
    cols = [torch.from_numpy(np.ascontiguousarray(c)) for c in batch]
    if torch.device(device).type == "cuda":
        return type(batch)(*(c.pin_memory().to(device, non_blocking=True)
                             for c in cols))
    return type(batch)(*cols)


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
    from pytorch_distributed_tpu_torch.factory import replica_active

    if replica_active(opt):
        # the replica plane (reference :72-94): an unsupported family, or
        # a topology with no registry and no coordinator, runs the solo
        # learner and says so
        from pytorch_distributed_tpu_torch.parallel import dcn as dcn_mod

        rp = dcn_mod.resolve_replica(opt.replica_params)
        if opt.agent_type != "dqn":
            print(f"[learner] replicas={rp.replicas} is only supported "
                  f"for agent_type=dqn (got {opt.agent_type}); running "
                  f"the solo learner", flush=True)
        elif dcn_mod.local_registry() is None and not rp.coordinator:
            print(f"[learner] replicas={rp.replicas} needs the fleet "
                  f"gateway's ReplicaRegistry (fleet --role learner) or "
                  f"replica_params.coordinator; running the solo learner",
                  flush=True)
        else:
            return run_replica_learner(opt, spec, process_ind, memory,
                                       param_store, clock, stats)
    ap = opt.agent_params
    device = resolve_device(opt)
    model = build_model(opt, spec)
    params = initial_params(opt, spec, device)
    state, step_fn = build_train_state_and_step(opt, model, params)
    host_flat = torch.empty(param_store.num_params)
    # the segment ring's ingest has the PER ring's learner surface
    on_device = isinstance(memory, (DeviceReplayIngest, DeviceSequenceIngest))
    is_device_per = on_device and memory.prioritized
    is_per = not on_device and memory.prioritized  # the host PER ring
    # the perf plane's monitor, on every ring; the FLOPs below on a device
    # ring only, as the reference's
    perf_mon = perf.get_monitor("learner", opt.perf_params)
    perf_mon.set_compute_dtype(compute_dtype(opt))
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

    publish_inline(published_params(opt, state))  # actors block on v1
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
        if perf_mon.enabled:
            # the graph must never be captured again after the warm-up;
            # no graph (the CPU): nothing to watch
            perf_mon.register_jit("fused_step",
                                  lambda: getattr(fused, "captures", None))
            perf_mon.capture_flops(lambda: update_flops(opt, spec))
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
    data = DataXray(opt, memory, param_store, sentinel.writer)
    tracer = data.tracer
    last_idx = None  # the last host batch's rows
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
    audit = perf_mon.audit
    # the first rate window starts here, not at start-up; the anchor's
    # rows carry the FLOPs per update and the first watermarks
    if perf_mon.enabled:
        sentinel.writer.scalars(perf_mon.drain(step=lstep), step=lstep)
    # a profile window asked for from another thread opens and closes in
    # this one, between two dispatches (utils/profiling.py)
    profiling.hold_windows()
    try:
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
                    profiling.poll_window()
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
                us = torch.rand((K, ap.batch_size), generator=gen,
                                device=device)
                with tracer.span("learn", trace_id=tracing.current_trace()):
                    if audit is not None:
                        state, metrics = audit.run(fused, state, replay.state,
                                                   us, beta)
                    else:
                        state, metrics = fused(state, replay.state, us, beta)
            else:
                with tracer.span("sample", trace_id=tracing.current_trace()):
                    batch = memory.sample(ap.batch_size, host_rng)
                last_idx = np.asarray(batch.index)
                if poison:
                    # the guard must skip this update, params unchanged
                    poison = False
                    batch = batch._replace(reward=np.full_like(
                        np.asarray(batch.reward), np.nan))
                    print("[faults:learner] poison_grad: NaN rewards injected "
                          "into this update's batch", flush=True)
                with tracer.span("learn", trace_id=tracing.current_trace()):
                    state, metrics, td_abs = step_fn(
                        state, upload_batch(batch, device))
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
            perf_mon.note_updates(K)
            profiling.poll_window()
            t3 = time.perf_counter()

            crossed = lambda freq: freq and lstep // freq != prev // freq
            if crossed(ap.param_publish_freq):
                if publisher is not None:
                    publisher.submit(published_params(opt, state))
                else:
                    publish_inline(published_params(opt, state))
            t4 = time.perf_counter()
            for key, dt in zip(spent, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                spent[key] += dt
            if crossed(ap.checkpoint_freq):
                saver.save(state, lstep, lstep0, gen, skipped)
            if crossed(ap.learner_freq):
                now = time.monotonic()
                vals = {k: float(v) for k, v in metrics.items()}
                rate = (lstep - window_lstep) / max(now - t_window, 1e-9)
                # DDPG reports its policy loss where DQN has q_mean
                second = ("actor_loss" if "learner/actor_loss" in vals
                          else "q_mean")
                # the MoE's load-balancing loss (reference :759-763)
                aux = (f" moe_aux {vals['learner/moe_aux']:.5g}"
                       if "learner/moe_aux" in vals else "")
                print(f"[learner] step {lstep} "
                      f"loss {vals['learner/critic_loss']:.5g} "
                      f"{second} {vals['learner/' + second]:.5g}{aux} "
                      f"{rate:.1f} updates/s replay {memory.size}", flush=True)
                if stats is not None:  # reference learner.py:757-766
                    stats.add(counter=1,
                              critic_loss=vals.get("learner/critic_loss", 0.0),
                              actor_loss=vals.get("learner/actor_loss", 0.0),
                              q_mean=vals.get("learner/q_mean", 0.0),
                              grad_norm=vals.get("learner/grad_norm", 0.0),
                              moe_aux=vals.get("learner/moe_aux", 0.0),
                              steps_per_sec=rate)
                n_skipped = saver.count_skipped(skipped)
                reason = sentinel.window(lstep, vals, n_skipped, td_mean)
                data.window(lstep, last_idx, sentinel.last_xray)
                if reason is not None:
                    state, lstep, lstep0 = sentinel.rollback(
                        reason, lstep, gen, n_skipped, host_rng)
                    next_beta = lstep  # beta follows the restored step
                if perf_mon.enabled:
                    drain_perf(perf_mon, sentinel.writer, memory, clock, lstep,
                               lstep0, ap.batch_size)
                t_window, window_lstep = now, lstep
    finally:
        profiling.release_windows()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.monotonic() - t_start
    actor_steps = clock.actor_step.value - actor_step0
    published = 0
    if publisher is not None:
        publisher.close()
        published = publisher.published
    publish_inline(published_params(opt, state))  # the finished weights
    # the final epoch, also on a preemption: a next run resumes from it
    saver.save(state, lstep, lstep0, gen, skipped)
    if perf_mon.enabled:  # the last partial window: a short run's rates
        sentinel.writer.scalars(perf_mon.drain(step=lstep), step=lstep)
    data.flush_traces(lstep)  # the last window's spans
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


# ---------------------------------------------------------------------------
# the learner replica plane (reference :930-1381)
# ---------------------------------------------------------------------------

def _copy_ring_(dst, src) -> None:
    """Write ``src``'s tensors into ``dst``'s in place (a captured graph
    keeps reading ``dst``'s), and its host cursors."""
    import dataclasses

    for f in dataclasses.fields(dst):
        val = getattr(src, f.name)
        if isinstance(val, torch.Tensor):
            getattr(dst, f.name).copy_(val)
        else:
            setattr(dst, f.name, val)


def _tree_to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return type(tree)(*(_tree_to(v, device) for v in tree))


class ReplicaLearnerDriver:
    """One data-parallel learner replica (reference :945-1296): the
    grad/apply halves (``factory.build_replica_grad_apply``), a PER ring of
    its own on its device (``DevicePerReplay``: every replica holds the
    whole ring, and the merged write-backs keep the N rings one priority
    plane) and the generation-stamped gradient rounds through ``channel``
    (parallel/dcn.py).

    - **Params** start from ``opt.seed`` on every replica, and every
      applied update is the registry's reduced mean, so the replicas'
      states never part while membership holds.
    - **Experience** is the shared synthetic stream: rows minted from
      ``np_rng(seed, "replica-ingest", counter)``, a counter every
      replica advances alike, so the N rings hold the same rows.
    - **Draws**: round ``r``'s B uniforms come from a torch generator
      seeded with ``replica_round_seed(base, r, rank)``, ``rank`` this
      replica's index in the sorted membership of the last completed
      round; ``key_log`` holds ``(r, seed)``.  The reference folds a
      threefry key with ``(r, rank)`` instead (ROADMAP.md, divergences);
      either way the survivor at rank 0 draws what a solo driver draws,
      so from the degradation round on it is a solo driver to the bit.
      ``uniforms(r, rank)`` is the hook a test uses to inject draws.
    - **Priorities**: each round's |TD| rides the submission, and the
      reply carries every contributor's in ascending replica order; each
      replica applies them all in turn (``per_apply_writeback_groups``).

    The draw (kernel B1) and the torso's forward and backward (kernel B2
    on the ``dqn-cnn`` kernel torso) run through the same wrappers as the
    fused learner's, on a GPU replayed from CUDA graphs
    (``GraphedReplicaStep``) with the exchange on the host between the
    halves.  ``REPLICA_FAULTS`` (utils/faults.py) is read once a round."""

    def __init__(self, opt: Options, spec: EnvSpec, replica_id: int,
                 channel, writer=None, ingest_rows_per_round: int = 0,
                 device=None):
        from pytorch_distributed_tpu_torch.factory import (
            build_replica_grad_apply,
        )
        from pytorch_distributed_tpu_torch.memory.device_per import (
            DevicePerReplay, GraphedReplicaStep, per_sample,
        )
        from pytorch_distributed_tpu_torch.memory.device_replay import (
            _torch_dtype,
        )
        from pytorch_distributed_tpu_torch.parallel.learner import (
            ReplicaExchange,
        )
        from pytorch_distributed_tpu_torch.utils.rngs import process_seed

        self.opt, self.spec = opt, spec
        self.replica = replica_id
        self.channel = channel
        self.writer = writer
        self.ingest_rows_per_round = ingest_rows_per_round
        self.device = torch.device(device) if device is not None \
            else resolve_device(opt)
        ap, mp_ = opt.agent_params, opt.memory_params
        model = build_model(opt, spec)
        params = init_params(opt, spec, seed=opt.seed, device=self.device)
        # the solo learner's state (its optimizer, interchangeable
        # checkpoints); its fused step is not used
        self.state, _ = build_train_state_and_step(opt, model, params)
        pair = build_replica_grad_apply(opt, model)
        if pair is None:
            raise ValueError(f"the replica plane does not serve "
                             f"agent_type={opt.agent_type}")
        grad_fn, apply_fn = pair
        self.replay = DevicePerReplay(
            mp_.memory_size, spec.state_shape, spec.action_shape,
            state_dtype=_torch_dtype(np.dtype(mp_.state_dtype)),
            action_dtype=_torch_dtype(np.dtype(spec.action_dtype)),
            device=self.device, priority_exponent=mp_.priority_exponent,
            importance_weight=mp_.priority_weight,
            importance_anneal_steps=ap.steps)

        def grad_part(ts, rs, us, beta):
            batch = per_sample(rs, us, beta)
            grads, ok, metrics, td_abs = grad_fn(ts, batch)
            return grads, ok, metrics, td_abs, batch.index

        self.halves = GraphedReplicaStep(
            grad_part, apply_fn, self.replay.state,
            counters=(hierarchical_sample, *GEMM_COUNTERS))
        self.exchange = ReplicaExchange(channel, spec.state_shape)
        # one base stream for every replica: the rank tells them apart
        self._base_seed = process_seed(opt.seed, "replica-plane", 0)
        self.round = 0
        self.members: list = []
        self.key_log: list = []      # (round, np.uint64 [seed])
        self.fence_events = 0
        self.rejoins = 0
        self.exchange_s = 0.0        # host seconds in the exchanges
        self._ingest_counter = 0
        self._recorder = flight_recorder.get_recorder(
            f"replica-{replica_id}")

    # -- the shared ingest stream ---------------------------------------------

    def _synth_chunk(self, rows: int):
        """``rows`` transitions of the counter-keyed shared stream: the
        same bytes on every replica (and in the reference) at the same
        counter."""
        from pytorch_distributed_tpu_torch.utils.experience import Transition
        from pytorch_distributed_tpu_torch.utils.rngs import np_rng

        ap = self.opt.agent_params
        rng = np_rng(self.opt.seed, "replica-ingest", self._ingest_counter)
        self._ingest_counter += 1
        shape = (rows,) + tuple(self.spec.state_shape)
        sdt = np.dtype(self.opt.memory_params.state_dtype)
        if sdt.kind == "u":
            s0 = rng.integers(0, 256, size=shape).astype(sdt)
            s1 = rng.integers(0, 256, size=shape).astype(sdt)
        else:
            s0 = rng.standard_normal(shape).astype(sdt)
            s1 = rng.standard_normal(shape).astype(sdt)
        if self.spec.discrete:
            action = rng.integers(0, max(1, self.spec.num_actions),
                                  size=(rows,)).astype(np.int32)
        else:
            action = rng.standard_normal(
                (rows, self.spec.action_dim)).astype(np.float32)
        return Transition(
            state0=s0, action=action,
            reward=rng.standard_normal(rows).astype(np.float32),
            gamma_n=np.full(rows, ap.gamma ** ap.nstep, np.float32),
            state1=s1,
            terminal1=(rng.random(rows) < 0.05).astype(np.float32))

    def prefill(self, rows: int) -> None:
        self.replay.feed_chunk(self._synth_chunk(rows))

    # -- state capture and restore (the parity oracle, the rejoin) -----------

    def snapshot(self) -> dict:
        """The train state and the ring on the host, the round and the
        ingest counter."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {"state": _tree_to(self.state, "cpu"),
                "ring": _tree_to_ring(self.replay.state),
                "round": self.round,
                "ingest_counter": self._ingest_counter}

    def load_snapshot(self, snap: dict) -> None:
        self.state = _tree_to(snap["state"], self.device)
        _copy_ring_(self.replay.state, snap["ring"])
        self.round = snap["round"]
        self._ingest_counter = snap["ingest_counter"]

    @property
    def lstep(self) -> int:
        return int(self.state.step)

    def _commit_epoch(self) -> int:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        ckpt.save_epoch(
            self.opt.model_name, state=self.state, memory=self.replay,
            extras=dict(learner_step=self.lstep, replica_round=self.round,
                        replica_ingest_counter=self._ingest_counter),
            retain=self.opt.agent_params.checkpoint_retain)
        return self.lstep

    # -- the round loop --------------------------------------------------------

    def _rank(self) -> int:
        if not self.members:
            return 0
        try:
            return sorted(self.members).index(self.replica)
        except ValueError:
            return 0

    def uniforms(self, round_idx: int, rank: int) -> torch.Tensor:
        """Round ``round_idx``'s B uniforms at ``rank``, logged."""
        from pytorch_distributed_tpu_torch.utils.rngs import (
            replica_round_seed,
        )

        seed = replica_round_seed(self._base_seed, round_idx, rank)
        self.key_log.append((round_idx, np.asarray([seed], np.uint64)))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.rand((self.opt.agent_params.batch_size,),
                          generator=gen, device=self.device)

    def run_rounds(self, until_round: int, *, stop=None, faults=None,
                   capture=None, on_round=None, rejoin: bool = False,
                   stats_every: int = 0) -> None:
        """Rounds ``[self.round, until_round)``.  ``capture(r, driver)``
        runs once round ``r`` is applied; ``rejoin`` turns a fence into
        the epoch-barrier rejoin instead of a ``ReplicaFenced``."""
        from pytorch_distributed_tpu_torch.memory.device_per import (
            per_apply_writeback_groups,
        )
        from pytorch_distributed_tpu_torch.parallel.dcn import (
            RSTAT_OK, ReplicaFenced,
        )

        inj = faults if faults is not None \
            else FaultInjector.from_env("replica")
        t_win, r_win = time.monotonic(), self.round
        while self.round < until_round:
            if stop is not None and stop.is_set():
                return
            r = self.round
            inj.frame(b"")  # kill@N, hang@N, crash@N, delay@N:S fire here
            profiling.poll_window()
            if self.ingest_rows_per_round > 0:
                self.prefill(self.ingest_rows_per_round)
            us = self.uniforms(r, self._rank())
            grads, ok, _metrics, td_abs, idx = self.halves.grad(
                self.state, us, self.replay.beta(self.lstep))
            t0 = time.perf_counter()
            pidx = idx.to(torch.int32).cpu().numpy()
            ptd = td_abs.float().cpu().numpy()
            ok_host = float(ok) > 0
            try:
                reply, reduced = self.exchange.exchange(
                    r, grads, ok=ok_host, pidx=pidx, ptd=ptd)
            except (ConnectionError, OSError) as e:
                raise ReplicaFenced(
                    f"replica {self.replica} lost the registry: {e}")
            self.exchange_s += time.perf_counter() - t0
            if reply["status"] != RSTAT_OK:
                self.fence_events += 1
                self._recorder.record("replica-fenced", round=r,
                                      status=reply["status"])
                if rejoin:
                    self.rejoin()
                    continue
                raise ReplicaFenced(f"replica {self.replica} fenced at "
                                    f"round {r} (status {reply['status']})")
            self.members = list(reply["members"])
            if reduced is not None:
                self.state = self.halves.apply(self.state, reduced, 1.0)
            # every contributor's write-back, in the reply's order, on
            # every replica: one priority plane over N rings
            per_apply_writeback_groups(
                self.replay.state,
                [(w[1], w[2]) for w in reply["writebacks"]],
                alpha=self.replay.alpha)
            self.round = r + 1
            if reply.get("epoch_due") and self._rank() == 0:
                self.channel.note_epoch(r, self._commit_epoch())
            if capture is not None:
                capture(r, self)
            if on_round is not None:
                on_round(r, reply)
            if stats_every and (r + 1) % stats_every == 0 \
                    and self.writer is not None:
                now = time.monotonic()
                self.writer.scalar(
                    "learner/updates_per_s",
                    (self.round - r_win) / max(now - t_win, 1e-9),
                    step=self.lstep)
                self.writer.scalar("replica/round", float(self.round),
                                   step=self.lstep)
                self.writer.flush()
                t_win, r_win = now, self.round

    # -- the rejoin ------------------------------------------------------------

    def _load_epoch(self, info) -> None:
        self.state = ckpt.load_epoch_state(info, self.device)
        if info.has_replay:
            ckpt.load_epoch_replay(info, self.replay)
        self._ingest_counter = int(info.extras.get(
            "replica_ingest_counter", self._ingest_counter))

    def rejoin(self, timeout: float = 60.0) -> None:
        """Lease at a new generation; behind live peers, wait for the
        join barrier's epoch, load it (params, optimizer, ring,
        counters), take the join round and activate.  With no live peer
        (a fresh plane or a whole-fleet restart) resume the newest epoch
        unless ``resume`` is "never", as the solo learner does."""
        from pytorch_distributed_tpu_torch.parallel.dcn import ReplicaFenced

        reply = self.channel.acquire()
        self.rejoins += 1
        self.members = list(reply.get("members", []))
        self.channel.start_renewer()
        barrier = reply.get("epoch_barrier")
        self._recorder.record("rejoin", generation=reply["generation"],
                              barrier=barrier)
        if barrier is None:
            self.round = int(reply.get("round", 0))
            if self.opt.resume != "never":
                info = ckpt.resolve_epoch(self.opt.model_name)
                if info is not None:
                    self._load_epoch(info)
                    self.round = max(self.round, int(
                        info.extras.get("replica_round", 0)))
                    print(f"[replica] {self.replica} resumed epoch "
                          f"{info.epoch} (step {info.learner_step}, "
                          f"round {self.round})", flush=True)
            return
        deadline = time.monotonic() + timeout
        epoch_step = None
        while time.monotonic() < deadline:
            j = self.channel.poll_join()
            if j is None:
                raise ReplicaFenced(
                    f"replica {self.replica} join cancelled")
            if j.get("epoch_step") is not None:
                epoch_step = int(j["epoch_step"])
                break
            time.sleep(0.05)
        if epoch_step is None:
            raise ReplicaFenced(
                f"replica {self.replica} barrier epoch never committed")
        info = ckpt.await_epoch(self.opt.model_name, epoch_step,
                                timeout=max(5.0, deadline
                                            - time.monotonic()))
        if info is None:
            raise ReplicaFenced(
                f"replica {self.replica} could not resolve the barrier "
                f"epoch (step >= {epoch_step})")
        self._load_epoch(info)
        self.round = int(reply.get("round",
                                   info.extras.get("replica_round", 0)))
        act = self.channel.activate(epoch_step)
        self.members = list(act.get("members", self.members))
        print(f"[replica] {self.replica} rejoined at generation "
              f"{self.channel.generation}, round {self.round} "
              f"(epoch step {epoch_step})", flush=True)


def _tree_to_ring(rs):
    """A ring state's copy on the host."""
    import dataclasses

    return dataclasses.replace(rs, **{
        f.name: getattr(rs, f.name).detach().to("cpu", copy=True)
        for f in dataclasses.fields(rs)
        if isinstance(getattr(rs, f.name), torch.Tensor)})


def _discard_ingest(memory) -> None:
    """Keep an ingest queue from backing up while the replica plane trains
    on the shared stream: its chunks are read and dropped."""
    read = getattr(memory, "read", None)
    if read is not None:
        read(1024)
    elif hasattr(memory, "drain"):
        memory.drain()


def run_replica_learner(opt: Options, spec: EnvSpec, process_ind: int,
                        memory, param_store: ParamStore, clock: GlobalClock,
                        stats: Optional[LearnerStats] = None,
                        replica_id: Optional[int] = None
                        ) -> Dict[str, float]:
    """The learner of a replicated fleet (reference :1298-1381): replica
    0, the lead, runs in the gateway's process and joins through a
    ``LocalReplicaChannel`` on the registry ``FleetTopology`` set
    (``dcn.local_registry``); replicas >= 1 run on their own hosts
    (``fleet --role learner-replica``) and dial
    ``replica_params.coordinator``.  The solo learner's ``memory`` is not
    trained on: the plane trains from the shared synthetic stream, as the
    reference's, and the ingest queue is drained and its chunks dropped
    (a line says so once).  Returns the run's summary."""
    from pytorch_distributed_tpu_torch.parallel import dcn as dcn_mod

    rp = dcn_mod.resolve_replica(opt.replica_params)
    rid = int(replica_id if replica_id is not None else process_ind)
    registry = dcn_mod.local_registry()
    if registry is not None:
        channel = dcn_mod.LocalReplicaChannel(registry, rid)
    else:
        host, _, port = rp.coordinator.rpartition(":")
        channel = dcn_mod.ReplicaClient((host, int(port)), rid, params=rp)
    ap = opt.agent_params
    writer = MetricsWriter(opt.log_dir, enable_tensorboard=False,
                           role="learner", run_id=opt.refs)
    driver = ReplicaLearnerDriver(opt, spec, rid, channel, writer=writer)
    if memory is not None:
        print(f"[replica] {rid}: the replica plane trains from the shared "
              f"synthetic stream; the local ingest queue is drained but "
              f"not consumed", flush=True)
    # the first lease goes through the rejoin: a fresh plane grants round
    # 0, a replacement entering mid-run gets the join barrier
    driver.rejoin(timeout=max(60.0, 4.0 * rp.join_timeout_s))
    channel.wait_members(rp.replicas, timeout=4.0 * max(rp.lease_s, 0.5))
    driver.members = channel.members()
    if driver.round == 0:
        driver.prefill(min(max(ap.learn_start, ap.batch_size),
                           opt.memory_params.memory_size))
    host_flat = torch.empty(param_store.num_params)

    def publish() -> None:
        flatten_into({k: v.detach().cpu() for k, v in
                      published_params(opt, driver.state).items()},
                     host_flat, spec.state_shape)
        param_store.publish(host_flat.numpy())

    publish()
    round0 = driver.round

    def on_round(r: int, reply: dict) -> None:
        clock.bump_progress("learner")
        clock.set_learner_step(driver.lstep)
        if ap.param_publish_freq and (r + 1) % ap.param_publish_freq == 0:
            publish()
        if ap.checkpoint_freq and (r + 1) % ap.checkpoint_freq == 0 \
                and driver._rank() == 0:
            driver._commit_epoch()
        if memory is not None:
            _discard_ingest(memory)

    t0 = time.monotonic()
    profiling.hold_windows()  # a profile window opens between two rounds
    try:
        driver.run_rounds(ap.steps, stop=clock.stop, on_round=on_round,
                          rejoin=(rid != 0),
                          stats_every=max(1, ap.learner_freq))
    finally:
        profiling.release_windows()
        if driver.device.type == "cuda":
            torch.cuda.synchronize(driver.device)
        seconds = time.monotonic() - t0
        publish()
        if driver._rank() == 0 and driver.round > 0:
            driver._commit_epoch()
        channel.release()
        channel.close()
        writer.close()
    rounds = driver.round - round0
    return {
        # the last published vector's digest: replicas hold one model
        "replica/params_sha256": hashlib.sha256(
            host_flat.numpy().tobytes()).hexdigest(),
        "learner/steps": driver.lstep,
        "learner/updates": rounds,
        "learner/updates_per_sec": rounds / max(seconds, 1e-9),
        "learner/train_seconds": seconds,
        "replica/id": rid,
        "replica/rounds": driver.round,
        "replica/degraded_rounds": driver.exchange.degraded_rounds,
        "replica/exchange_seconds": driver.exchange_s,
        "replica/fence_events": driver.fence_events,
        "replica/rejoins": driver.rejoins,
        "replica/members": len(driver.members),
        "replica/peak_allocated_bytes": (
            torch.cuda.max_memory_allocated(driver.device)
            if driver.device.type == "cuda" else 0),
        "actor/steps": clock.actor_step.value,
    }
