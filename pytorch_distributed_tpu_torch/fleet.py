"""The fleet: one learner host, learner replica hosts, a standby gateway
and actor hosts over the DCN wire — the port of
pytorch_distributed_tpu/fleet.py: ``FleetTopology`` (:77-363, with the
replica registry, the profile and metrics providers and the HA plane),
``run_fleet_learner`` (:365-372), ``run_replica_host`` (:375-429),
``run_gateway_standby`` (:431-513), ``_remote_actor_main`` (:640-725),
``run_fleet_actors`` (:728-956, with its ``MetricsPusher``) and ``main``
(:963-1093) with every role but ``replay-shard``.

    python -m pytorch_distributed_tpu_torch.fleet --role learner \\
        --config 12 --port 5555 --local-actors 0 [--device cpu]
    python -m pytorch_distributed_tpu_torch.fleet --role actors \\
        --config 12 --coordinator 127.0.0.1:5555 --actor-base 0 \\
        --actor-count 2

Fleet-wide semantics are the single host's: ``num_actors`` counts every
actor of the fleet, each on its global slot (the Ape-X epsilons span the
fleet); the learner's clock ends every loop on every host, carried by the
gateway's replies; stats land in the learner host's accumulators.  The
learner host runs the learner on the card unless ``--device cpu`` is
given, and its actor slots below ``--local-actors`` as the runtime does;
its gateway (parallel/dcn.py) takes the other slots' chunks into the
same ingest.  An actor host runs its actors' policies on the CPU: a
remote actor host is a CPU-only host, as in the reference.

Failure model (parallel/dcn.py): a gateway restart, a severed or
blackholed link and a corrupt frame are ridden through (redial, re-HELLO
with a higher incarnation, resend of the unacked chunk); a loss past
``--reconnect-timeout`` makes the actor exit ``EXIT_DISCONNECTED``, and
the actor host's ``RestartBudget`` respawns it (3 a slot, 2, 4, 8 s
backoff); a slot out of budget fails the host with exit 1.  The
learner's stop ends every actor with exit 0.  ``--faults-client`` and
``--faults-gateway`` schedule wire faults (utils/faults.py).

Learner replicas (``--set replicas=N``): the learner host's gateway
carries the ``ReplicaRegistry``, and its learner is replica 0, the lead,
joined in process; each ``--role learner-replica --replica-id i
--coordinator H:P`` host is another replica, on the card unless
``--device cpu``.  They train one model in generation-stamped rounds
(parallel/dcn.py, agents/learner.py ``run_replica_learner``) on the
shared synthetic stream, as the reference's; a killed replica leaves the
others training in degraded rounds, and a replacement rejoins through
the epoch barrier.  A replica host that loses its lease exits
``EXIT_DISCONNECTED``.

The gateway's HA plane (``TPU_APEX_GATEWAY_ENABLED=1`` or ``--set
gateway_params.enabled=true``): the learner host's gateway journals
under ``{log_dir}/gateway/``; ``--role gateway-standby --coordinator
H:P`` runs a warm standby on the CPU (it trains nothing: a param store, a
clock and a bounded spool of the experience it takes once promoted),
which promotes when the primary stops answering for a lease; actor hosts
given ``--coordinator H:P,H:PS`` fail over to it.  With the metrics plane
on (``TPU_APEX_METRICS=1``) an actor host's ``MetricsPusher`` pushes its
scalar rows into the learner host's mission control over ``T_METRICS``;
``parallel.dcn.fetch_profile`` opens a profile window in the learner
host's process (``T_PROFILE``), warmed at start when the perf plane is
on.

The role ``replay-shard`` and the reference's ``ShardParams`` fields are
not ported (ROADMAP.md Queue A item 8 (iii)).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing as mp
import os
import signal
import sys
import threading
import time
import warnings
from typing import List, Optional

from pytorch_distributed_tpu_torch.config import (
    Options, build_options, parse_set_overrides,
)
from pytorch_distributed_tpu_torch.runtime import Topology

_CTX = mp.get_context("spawn")

# what the learner host's close waits, at most, for remote actors to take
# the stop from an ack and leave
_PART_S = 10.0


class FleetTopology(Topology):
    """The learner host's topology: the runtime's workers minus the remote
    actor slots, and a ``DcnGateway`` bridging the remote hosts into the
    shared plane."""

    def __init__(self, opt: Options, local_actors: int = 0, port: int = 0,
                 spec=None, backend: str = "process", max_restarts: int = 3,
                 host: str = "0.0.0.0"):
        # before the runtime sizes its board: local slots are [0, local)
        self.local_actors = min(local_actors, opt.num_actors)
        super().__init__(opt, spec=spec, backend=backend,
                         max_restarts=max_restarts)
        # the learner-rate window of the STATUS snapshot (concurrent
        # serve threads probe it)
        self._rate_lock = threading.Lock()
        self._rate_prev = None
        from pytorch_distributed_tpu_torch.factory import (
            resolve_actor_backend,
        )

        with warnings.catch_warnings():  # the runtime warned already
            warnings.simplefilter("ignore")
            self._actor_backend = resolve_actor_backend(
                opt, self.inference_server)
        self._host = host
        # the profiler's one-time set-up, paid before the gateway binds:
        # seconds of a held GIL here starve no peer or standby, and the
        # first T_PROFILE then opens at window speed
        self.profiler_prewarm_s: Optional[float] = None
        if self.perf.enabled:
            from pytorch_distributed_tpu_torch.utils import perf

            if threading.current_thread() is threading.main_thread():
                self.profiler_prewarm_s = perf.prewarm_profiler()
                print(f"[fleet] profiler prewarmed in "
                      f"{self.profiler_prewarm_s:.2f} s", flush=True)
            else:
                print("[fleet] profiler not prewarmed: the topology was "
                      "not built on the main thread", flush=True)
        # the replica registry rides this gateway; the lead learner (this
        # process) joins through the module's handle, not over loopback
        if self.replica.replicas > 1:
            from pytorch_distributed_tpu_torch.parallel.dcn import (
                ReplicaRegistry, set_local_registry,
            )

            self.replica_registry = ReplicaRegistry(
                self.replica,
                writer=(self.mission._writer
                        if self.mission is not None else None))
            set_local_registry(self.replica_registry)
        self.gateway = self._make_gateway(port)
        self.port = self.gateway.port

    def _num_actor_workers(self) -> int:
        # remote hosts take the slots from local_actors up
        return 0 if self.anakin else self.local_actors

    def _make_gateway(self, port: int):
        """The one construction point, shared with ``restart_gateway``."""
        from pytorch_distributed_tpu_torch.parallel.dcn import (
            DcnGateway, feed_queue_of,
        )

        return DcnGateway(
            self.param_store, self.clock, self.actor_stats,
            put_chunk=feed_queue_of(self.handles), host=self._host,
            port=port, local_actors=self.local_actors,
            health=self._health_snapshot,
            profiler=self._profile_request,
            metrics_sink=self._metrics_sink,
            flow_params=self.flow,
            pressure=self._flow_pressure,
            flow_writer=(self.mission._writer
                         if self.mission is not None else None),
            replicas=self.replica_registry,
            gateway_params=self.gateway_ha,
            log_dir=(self.opt.log_dir if self.gateway_ha.enabled else None),
            ha_writer=(self.mission._writer
                       if self.mission is not None else None))

    def _metrics_sink(self, payload: dict) -> int:
        """``T_METRICS``: a remote host's rows into mission control; with
        the plane off nothing is absorbed (the reply says accepted 0)."""
        if self.mission is None:
            return 0
        return self.mission.ingest_remote(payload)

    def _profile_request(self, msg: dict) -> dict:
        """``T_PROFILE``: a bounded profile window of this process, the
        learner host's, which owns the card; the learner's thread opens
        and closes it between two updates (utils/profiling.py).  Another
        role is refused: its process is not this one."""
        from pytorch_distributed_tpu_torch.utils import perf

        role = str(msg.get("role", "learner"))
        if role != "learner":
            return {"error": f"role {role!r} not profilable over "
                             f"T_PROFILE: only the learner host process "
                             f"(the card's owner) captures traces"}
        label = msg.get("label") or time.strftime("tprofile_%H%M%S")
        return perf.run_profile_window(
            os.path.join(self.opt.log_dir, "profiles"), label=str(label),
            seconds=msg.get("seconds", 3.0),
            max_seconds=self.perf.profile_window_max)

    def _flow_pressure(self) -> float:
        """The governor's input: the ingest queues' fill; 0.0 where it
        cannot be read (unknown pressure reads healthy)."""
        ls = self.handles.learner_side
        bound = int(getattr(ls, "max_queue_chunks", 0) or 0)
        depth = ls.queue_depth() if hasattr(ls, "queue_depth") else None
        if depth is None or bound <= 0:
            return 0.0
        return min(1.0, depth / bound)

    def _health_snapshot(self) -> dict:
        """The topology's fields of the gateway's STATUS: replay fill,
        ingest depth, learner and fleet rates, the local actors' frame
        rates, the health sentinel's counts, the local restart budget,
        and the perf, Anakin and mission-control blocks when on."""
        from pytorch_distributed_tpu_torch.utils import health, perf

        h: dict = {"run_id": self.opt.refs}
        ls = self.handles.learner_side
        try:  # a device ring raises before attach
            size = int(ls.size)
            h["replay_size"] = size
            cap = int(getattr(ls, "capacity", 0))
            if cap:
                h["replay_capacity"] = cap
                h["replay_fill"] = round(size / cap, 4)
        except Exception:  # noqa: BLE001
            pass
        depth = ls.queue_depth() if hasattr(ls, "queue_depth") else None
        if depth is not None:
            h["ingest_queue_depth"] = int(depth)
            h["ingest_queue_bound"] = int(getattr(ls, "max_queue_chunks", 0))
        now = time.monotonic()
        step = int(self.clock.learner_step.value)
        astep = int(self.clock.actor_step.value)
        n_envs = max(1, self.opt.env_params.num_envs_per_actor)
        marks = {i: self.progress_board.marks(f"actor-{i}")
                 for i in range(self._num_actor_workers())}
        with self._rate_lock:
            prev = self._rate_prev
            # the window moves on only once it is half a second wide
            if prev is None or now - prev[0] >= 0.5:
                self._rate_prev = (now, step, astep, marks)
        if prev is not None and now > prev[0]:
            h["learner_steps_per_sec"] = round(
                (step - prev[1]) / (now - prev[0]), 3)
            h["actor_frames_per_sec"] = round(
                (astep - prev[2]) / (now - prev[0]), 3)
            if marks:
                h["actors"] = {
                    str(i): {
                        "env_frames_per_sec": round(max(
                            0.0, (m - prev[3].get(i, 0)) * n_envs
                            / (now - prev[0])), 1),
                        "backend": self._actor_backend,
                    } for i, m in marks.items()}
        h["health_sentinel"] = {
            "skipped_steps": int(self.clock.skipped_steps.value),
            "rollbacks": int(self.clock.rollbacks.value),
            "hang_kills": int(self.hang_kills),
            # the gateway's own per-slot counts are in its "quarantined"
            "quarantined_local": {
                s: n for s, n in health.quarantine_counts().items()
                if not s.startswith("gateway-")},
        }
        budget = self._restart_budget
        if budget is not None:
            h["local_restart_budget_remaining"] = {
                str(s): r for s, r in budget.remaining().items()}
        psnap = perf.status_snapshot()
        if psnap:
            h["perf"] = psnap
        if self.anakin:
            snap = (psnap or {}).get("learner", {})
            h["anakin"] = {
                "backend": "anakin",
                "duty_cycle": snap.get("anakin/duty_cycle"),
                "rollout_frames_per_s":
                    snap.get("anakin/rollout_frames_per_s"),
                "replay_fill": snap.get("anakin/replay_fill",
                                        h.get("replay_fill")),
                "mfu": snap.get("learner/mfu"),
            }
        if self.mission is not None:
            h.update(self.mission.status_block())
        return h

    def _pre_close(self) -> None:
        # the stop is set: give the remote actors a bounded wait to read
        # it from an ack and leave, then close the gateway before the
        # ingest's queues (a put on a closed ingest would end a serve
        # thread)
        deadline = time.monotonic() + _PART_S
        while self.gateway.active_slots and time.monotonic() < deadline:
            time.sleep(0.05)
        self.gateway.close()
        if self.replica_registry is not None:
            # a later topology of this process must not join this run's
            # closed registry
            from pytorch_distributed_tpu_torch.parallel.dcn import (
                local_registry, set_local_registry,
            )

            if local_registry() is self.replica_registry:
                set_local_registry(None)

    def restart_gateway(self) -> None:
        """Close the gateway and bind a new one on the same port: the
        drill of a learner host's network blip.  Remote actors redial,
        re-HELLO with higher incarnations and resend their unacked
        chunks."""
        port = self.gateway.port
        self.gateway.close()
        self.gateway = self._make_gateway(port)

    def run(self):
        try:
            return super().run()
        finally:
            self.gateway.close()  # idempotent; covers a failed start


def run_fleet_learner(opt: Options, local_actors: int = 0, port: int = 5555,
                      backend: str = "process") -> dict:
    topo = FleetTopology(opt, local_actors=local_actors, port=port,
                         backend=backend)
    print(f"[fleet] learner host up: gateway on port {topo.port}, "
          f"{topo.local_actors}/{opt.num_actors} actors local", flush=True)
    summary = topo.run()
    summary["gateway/chunks_in"] = topo.gateway.chunks_in
    summary["gateway/connections"] = topo.gateway.connections
    summary["gateway/fenced"] = topo.gateway.fenced
    summary["gateway/faults_injected"] = topo.gateway.faults_injected
    summary["gateway/metrics_batches"] = topo.gateway.metrics_batches
    summary["gateway/profiles_served"] = topo.gateway.profiles_served
    if topo.profiler_prewarm_s is not None:
        summary["perf/profiler_prewarm_s"] = topo.profiler_prewarm_s
    if topo.replica_registry is not None:
        reg = topo.replica_registry
        summary.update({"replica/rounds_completed": reg.rounds_completed,
                        "replica/degraded_completions":
                            reg.degraded_completions,
                        "replica/leases_expired": reg.leases_expired})
    summary.update(kernel_launches())
    return summary


def kernel_launches() -> dict:
    """This process's launches of each kernel (B1's draws, B2's products)
    since it started or the counters were last zeroed."""
    from pytorch_distributed_tpu_torch.ops.cuda_sampling import (
        hierarchical_sample,
    )
    from pytorch_distributed_tpu_torch.ops.cuda_torso import COUNTERS

    return {f"kernels/{c.__name__}": c.launches
            for c in (hierarchical_sample, *COUNTERS)}


# -- the replica host ---------------------------------------------------------------

def run_replica_host(opt: Options, coordinator: str,
                     replica_id: int) -> dict:
    """One learner replica on its own host (reference :375-429): it dials
    the lead gateway's replica plane and trains the shared model
    (agents/learner.py ``run_replica_learner``) on ``opt.device``.  The
    run's end returns the summary (exit 0); a fence whose rejoin failed
    exits ``EXIT_DISCONNECTED`` for an outer supervisor, whose respawn
    leases at a new generation and loads the join barrier's epoch.
    SIGTERM drains the rounds, commits, releases and exits 0."""
    from pytorch_distributed_tpu_torch.agents.clocks import (
        GlobalClock, LearnerStats,
    )
    from pytorch_distributed_tpu_torch.agents.learner import (
        run_replica_learner,
    )
    from pytorch_distributed_tpu_torch.agents.param_store import (
        ParamStore, num_params,
    )
    from pytorch_distributed_tpu_torch.factory import (
        build_model, probe_env, resolve_device,
    )
    from pytorch_distributed_tpu_torch.parallel.dcn import ReplicaFenced
    from pytorch_distributed_tpu_torch.utils import flight_recorder
    from pytorch_distributed_tpu_torch.utils.supervision import (
        EXIT_DISCONNECTED,
    )

    resolve_device(opt)  # fail before anything dials
    opt.replica_params.coordinator = coordinator
    flight_recorder.configure(opt.log_dir, run_id=opt.refs)
    spec = probe_env(opt)
    store = ParamStore(num_params(
        build_model(opt, spec, init_weights=False).state_dict()))
    clock = GlobalClock()
    # the handler only sets an event; a watcher sets the shared stop,
    # whose lock the interrupted thread may hold
    term = threading.Event()
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, lambda s, f: term.set())

        def watch() -> None:
            term.wait()
            clock.stop.set()

        threading.Thread(target=watch, name="replica-sigterm",
                         daemon=True).start()
    print(f"[fleet] replica host up: replica {replica_id} -> "
          f"{coordinator}", flush=True)
    try:
        summary = run_replica_learner(opt, spec, replica_id, None, store,
                                      clock, LearnerStats(),
                                      replica_id=replica_id)
    except (ReplicaFenced, ConnectionError, OSError) as e:
        print(f"[fleet] replica-{replica_id} lost its lease or session "
              f"({e}); exiting {EXIT_DISCONNECTED} for the supervisor",
              flush=True)
        flight_recorder.dump_all(
            f"replica-{replica_id} fenced or disconnected")
        sys.exit(EXIT_DISCONNECTED)
    summary["runtime/preempted"] = int(term.is_set())
    summary.update(kernel_launches())
    return summary


# -- the standby gateway --------------------------------------------------------------

def run_gateway_standby(opt: Options, coordinator: str,
                        port: int = 0) -> dict:
    """``--role gateway-standby`` (reference :431-513): a warm standby of
    the HA plane on the CPU.  It pulls the primary's journal over
    ``T_SYNC``, refuses session verbs (counted) until the primary has
    been silent for a lease, then promotes on the shared ``TERM.json``
    and serves.  It trains nothing: a param store, a clock and a bounded
    drop-oldest spool of the experience it takes once promoted, which
    keeps the actors alive and counted while a learner host is brought
    back from the checkpoints.  SIGTERM sets its clock's stop, gives the
    remote actors ``_PART_S`` to take it from an ack and leave, as the
    learner host does, and exits 0 (the reference's standby closes at
    once).  Returns the counts."""
    import collections

    from pytorch_distributed_tpu_torch.agents.clocks import (
        ActorStats, GlobalClock,
    )
    from pytorch_distributed_tpu_torch.agents.param_store import (
        ParamStore, num_params,
    )
    from pytorch_distributed_tpu_torch.factory import build_model, probe_env
    from pytorch_distributed_tpu_torch.parallel.dcn import (
        DcnGateway, parse_endpoints, resolve_gateway,
    )
    from pytorch_distributed_tpu_torch.utils import flight_recorder

    gp = resolve_gateway(opt.gateway_params)
    if not gp.enabled:
        raise SystemExit(
            "--role gateway-standby needs the HA plane on: set "
            "TPU_APEX_GATEWAY_ENABLED=1 (or --set "
            "gateway_params.enabled=true)")
    flight_recorder.configure(opt.log_dir, run_id=opt.refs)
    spec = probe_env(opt)
    store = ParamStore(num_params(
        build_model(opt, spec, init_weights=False).state_dict()))
    clock = GlobalClock()
    spool: collections.deque = collections.deque(maxlen=4096)
    spooled = [0]

    def _spool(items: list) -> None:
        spool.append(items)
        spooled[0] += len(items)

    bind_host, bind_port = "0.0.0.0", port
    if gp.standby:
        eps = parse_endpoints(gp.standby)
        if eps:
            bind_host, bind_port = eps[0]
    primary = parse_endpoints(coordinator)[0]
    gw = DcnGateway(store, clock, ActorStats(), put_chunk=_spool,
                    host=bind_host, port=bind_port, gateway_params=gp,
                    log_dir=opt.log_dir, ha_role="standby",
                    sync_from=primary)
    # the handler sets a plain event polled below: it must not take the
    # clock's lock the main thread could hold
    host_stop = threading.Event()
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, lambda s, f: host_stop.set())
    print(f"[fleet] gateway standby up on port {gw.port}, syncing "
          f"{primary[0]}:{primary[1]} (lease {gp.lease_s:g}s)", flush=True)
    try:
        while not host_stop.wait(0.5) and not clock.stop.is_set():
            pass
    finally:
        # as the learner host parts: the stop rides the next acks, and
        # the remote actors get a bounded wait to take it and leave
        clock.stop.set()
        deadline = time.monotonic() + _PART_S
        while gw.active_slots and time.monotonic() < deadline:
            time.sleep(0.05)
        role = gw.status_snapshot().get("gateway", {})
        gw.close()
        print(f"[fleet] gateway standby exiting: role "
              f"{role.get('role')!r} term {role.get('term')} "
              f"(spooled {spooled[0]} rows post-promotion)", flush=True)
    return {"gateway/role": role.get("role"), "gateway/term": role.get("term"),
            "gateway/promotions": role.get("promotions"),
            "gateway/standby_refused": role.get("standby_refused"),
            "gateway/spooled_rows": spooled[0],
            "gateway/chunks_in": gw.chunks_in}


# -- the actor host ----------------------------------------------------------------

def _remote_actor_main(opt: Options, coordinator: str, process_ind: int,
                       progress=None) -> None:
    """One remote rollout worker: the DCN adapters in place of the shared
    plane, then the run's actor (agents/actor.py) unchanged, on the CPU.
    The learner's stop exits 0; a terminal session loss exits
    ``EXIT_DISCONNECTED`` for the host's supervisor."""
    from pytorch_distributed_tpu_torch.agents.actor import run_actor
    from pytorch_distributed_tpu_torch.factory import probe_env
    from pytorch_distributed_tpu_torch.parallel.dcn import (
        DcnClient, DcnRefused, RemoteClock, RemoteMemory, RemoteParamStore,
        RemoteStats, parse_endpoints,
    )
    from pytorch_distributed_tpu_torch.utils import flight_recorder
    from pytorch_distributed_tpu_torch.utils.supervision import (
        EXIT_DISCONNECTED,
    )

    # the placement of the role: a remote actor host is a CPU-only host
    opt = dataclasses.replace(opt, device="cpu")
    flight_recorder.configure(opt.log_dir, run_id=opt.refs)
    recorder = flight_recorder.get_recorder(f"actor-{process_ind}")
    recorder.record("session-start", coordinator=coordinator)
    try:
        client = DcnClient(parse_endpoints(coordinator),
                           process_ind=process_ind)
    except (ConnectionError, OSError, DcnRefused) as e:
        # no session: a network or learner-host condition, not a crash
        print(f"[fleet] actor-{process_ind} could not establish its DCN "
              f"session ({e}); exiting {EXIT_DISCONNECTED}", flush=True)
        recorder.record("session-refused", error=repr(e))
        flight_recorder.dump_all(
            f"actor-{process_ind} could not establish DCN session")
        sys.exit(EXIT_DISCONNECTED)
    memory = RemoteMemory(client)
    clock = RemoteClock(client)
    clock.progress = progress
    try:
        run_actor(opt, probe_env(opt), process_ind, memory,
                  RemoteParamStore(client), clock, RemoteStats(client))
    except (ConnectionError, OSError):
        # a terminal loss leaves the loop through its busiest RPC; any
        # other transport error is a bug and propagates
        if not client.disconnected.is_set():
            raise
    finally:
        try:
            memory.flush()
            clock.flush()
        except (ConnectionError, OSError):
            pass
        client.close()
    if client.disconnected.is_set() and not client.stop.is_set():
        print(f"[fleet] actor-{process_ind} lost its DCN session; "
              f"exiting {EXIT_DISCONNECTED} for the supervisor", flush=True)
        recorder.record("session-lost", reconnects=client.reconnects)
        flight_recorder.dump_all(f"actor-{process_ind} DCN session lost")
        sys.exit(EXIT_DISCONNECTED)
    recorder.record("run-complete", reconnects=client.reconnects)
    print(f"[fleet] actor-{process_ind} done (reconnects "
          f"{client.reconnects}, faults {client.faults_injected}, "
          f"failovers {client.failovers})", flush=True)


def _remote_actor_child(opt: Options, coordinator: str, process_ind: int,
                        progress, num_threads: int) -> None:
    """Spawn trampoline: no GPU is visible to the child, and it takes its
    share of the host's cores."""
    from pytorch_distributed_tpu_torch.runtime import enter_child

    enter_child(num_threads)
    _remote_actor_main(opt, coordinator, process_ind, progress)


def run_fleet_actors(opt: Options, coordinator: str, actor_base: int,
                     actor_count: int, backend: str = "process",
                     max_restarts: int = 3) -> List[int]:
    """Run ``actor_count`` rollout workers on the global slots
    ``[actor_base, actor_base + actor_count)``.  On the process backend
    each slot is supervised with a ``RestartBudget`` (backoff on) and,
    with ``hang_deadline > 0``, the hang watchdog over the host's
    ``ProgressBoard``; a clean exit is final.  Returns the slots abandoned
    out of budget (the CLI exits 1 for any)."""
    if actor_base + actor_count > opt.num_actors:
        raise ValueError(
            f"actor slots [{actor_base}, {actor_base + actor_count}) exceed "
            f"fleet num_actors={opt.num_actors}")
    from pytorch_distributed_tpu_torch.factory import prebuild_native
    from pytorch_distributed_tpu_torch.parallel.dcn import parse_endpoints
    from pytorch_distributed_tpu_torch.utils import (
        flight_recorder, health, telemetry,
    )
    from pytorch_distributed_tpu_torch.utils.supervision import (
        EXIT_CRASH, EXIT_HUNG, ProgressBoard, RestartBudget, describe_exit,
    )

    prebuild_native(opt)  # once, before the workers race one g++
    # the push leg of mission control: with the metrics plane on, a
    # MetricsPusher tails this host's scalars.jsonl and ships its rows to
    # the learner host over T_METRICS, offset onto its clock.  It dials
    # the first endpoint; each push has its own timeout and one retry, so
    # a failover costs dropped batches, not a stuck thread
    pusher = None
    mparams = telemetry.resolve_metrics(opt.metrics_params)
    if mparams.enabled:
        pusher = telemetry.MetricsPusher(parse_endpoints(coordinator)[0],
                                         opt.log_dir, mparams)
        pusher.start()
    hp = health.resolve(opt.health_params)
    board = ProgressBoard([f"actor-{actor_base + i}"
                           for i in range(actor_count)])
    threads = max(1, (os.cpu_count() or 1) // max(1, actor_count))
    thread_exits: dict = {}  # slot -> nonzero exit (thread backend)

    def spawn(ind: int):
        board.note_start(f"actor-{ind}")
        if backend == "process":
            w = _CTX.Process(target=_remote_actor_child,
                             args=(opt, coordinator, ind, board, threads),
                             name=f"fleet-actor-{ind}", daemon=True)
        else:
            def _thread_main(ind=ind):
                try:
                    _remote_actor_main(opt, coordinator, ind)
                except SystemExit as e:
                    # a thread swallows SystemExit: keep the code
                    thread_exits[ind] = int(e.code or 0)
                except BaseException:
                    thread_exits[ind] = EXIT_CRASH
                    raise

            w = threading.Thread(target=_thread_main,
                                 name=f"fleet-actor-{ind}", daemon=True)
        w.start()
        return w

    workers = {actor_base + i: spawn(actor_base + i)
               for i in range(actor_count)}
    print(f"[fleet] actor host up: {actor_count} actors "
          f"(slots {actor_base}..{actor_base + actor_count - 1}) -> "
          f"{coordinator}", flush=True)
    if backend != "process":
        for w in workers.values():
            w.join()
        bad = {ind: code for ind, code in thread_exits.items() if code}
        if pusher is not None:
            pusher.stop()  # its last drain rides the stop
        if bad:
            raise RuntimeError(
                f"actor host FAILED (thread backend): worker exit codes "
                f"{bad}")
        return []

    flight_recorder.configure(opt.log_dir, export_env=True,
                              run_id=opt.refs)
    host_recorder = flight_recorder.get_recorder("fleet-host")
    budget = RestartBudget(max_restarts=max_restarts, backoff=True)
    for ind in workers:
        budget.note_birth(ind)
    # SIGTERM: the host is preempted; it holds no state to save, so it
    # stops respawning and ends its workers
    host_stop = threading.Event()
    prev_term = None
    if threading.current_thread() is threading.main_thread():
        try:
            prev_term = signal.signal(
                signal.SIGTERM, lambda s, f: host_stop.set())
        except (ValueError, OSError):  # pragma: no cover
            prev_term = None
    pending: dict = {}  # slot -> respawn time (backoff)
    abandoned: List[int] = []

    def restart_or_abandon(ind: int, code: int, now: float,
                           why: str = "") -> None:
        delay = budget.request_restart(ind)
        del workers[ind]
        if delay is not None:
            print(f"[fleet] actor-{ind} {why}({describe_exit(code)}); "
                  f"restart {budget.count(ind)}/{max_restarts} "
                  f"in {delay:.0f}s", flush=True)
            host_recorder.record("worker-restarted", slot=ind, exit=code,
                                 restarts=budget.count(ind), delay=delay)
            pending[ind] = now + delay
        else:
            print(f"[fleet] actor-{ind} out of restart budget; "
                  f"abandoning slot", flush=True)
            host_recorder.record("slot-abandoned", slot=ind, exit=code)
            abandoned.append(ind)

    while (workers or pending) and not host_stop.is_set():
        time.sleep(0.5)
        now = time.monotonic()
        for ind, at in list(pending.items()):
            if now >= at:
                del pending[ind]
                workers[ind] = spawn(ind)
                budget.note_birth(ind)
        for ind, w in list(workers.items()):
            if w.is_alive():
                continue
            if w.exitcode == 0:
                del workers[ind]  # this slot's run is complete
                continue
            restart_or_abandon(ind, w.exitcode, now, "died ")
        if hp.hang_deadline > 0:
            hung = set(board.hung(hp.hang_deadline, hp.hang_grace,
                                  only=[f"actor-{i}" for i in workers]))
            for ind, w in list(workers.items()):
                if f"actor-{ind}" not in hung or not w.is_alive():
                    continue
                host_recorder.record(
                    "worker-hung", slot=ind,
                    age=round(board.age(f"actor-{ind}"), 1))
                flight_recorder.dump_all(
                    f"actor-{ind} hung (> {hp.hang_deadline:g}s without "
                    f"progress); watchdog SIGKILL")
                w.kill()
                w.join(10.0)
                restart_or_abandon(ind, EXIT_HUNG, now)
        if abandoned:
            # fail fast: a host running a reduced fleet is the silent
            # degradation this supervision exists to prevent
            flight_recorder.dump_all(
                f"actor host failing fast: slots {abandoned} out of "
                f"restart budget")
            for ind, w in list(workers.items()):
                print(f"[fleet] terminating healthy actor-{ind} "
                      "(host failing fast)", flush=True)
                w.terminate()
                w.join(10.0)
            workers.clear()
            pending.clear()
            break
    if host_stop.is_set():
        print(f"[fleet] SIGTERM: preemption notice — terminating "
              f"{len(workers)} actors on this host", flush=True)
        host_recorder.record("sigterm-preemption", live=len(workers))
        flight_recorder.dump_all("SIGTERM preemption notice (actor host)")
        for ind, w in list(workers.items()):
            w.terminate()
            w.join(10.0)
        workers.clear()
        pending.clear()
    if prev_term is not None:
        signal.signal(signal.SIGTERM, prev_term)
    if pusher is not None:
        pusher.stop()  # its last drain rides the stop
        print(f"[fleet] metrics pusher: {pusher.pushed_rows} rows pushed, "
              f"{pusher.push_errors} push errors, {pusher.dropped_rows} "
              f"dropped", flush=True)
    return abandoned


# -- the CLI -----------------------------------------------------------------------

_UNPORTED_ROLES = ("replay-shard",)


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(
        prog="pytorch_distributed_tpu_torch.fleet",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--role", choices=("learner", "actors",
                                       "learner-replica", "gateway-standby")
                    + _UNPORTED_ROLES, required=True,
                    help="learner: the learner host (the learner on the "
                         "card unless --device cpu, its gateway, its local "
                         "actors; with --set replicas=N replica 0); "
                         "learner-replica: one more learner replica, on "
                         "the card unless --device cpu; gateway-standby: "
                         "a warm standby gateway of the HA plane, on the "
                         "CPU by its placement (it trains nothing); "
                         "actors: an actor host, whose actors run their "
                         "policies on the CPU (a remote actor host is a "
                         "CPU-only host, as in the reference); "
                         "replay-shard is not ported")
    ap.add_argument("--replica-id", type=int, default=1,
                    help="[learner-replica] this host's replica id (0 is "
                         "the learner host's; ids are unique in the fleet)")
    ap.add_argument("--config", type=int, default=1)
    ap.add_argument("--num-actors", type=int, default=None,
                    help="the fleet's actor count over every host "
                         "(default: the config's)")
    ap.add_argument("--port", type=int, default=5555,
                    help="[learner|gateway-standby] the gateway's port (0: "
                         "any free one)")
    ap.add_argument("--local-actors", type=int, default=0,
                    help="[learner] actors on the learner host")
    ap.add_argument("--coordinator", type=str, default=None,
                    help="[actors|learner-replica|gateway-standby] the "
                         "learner host as host:port; an actor host may give "
                         "an ordered list h1:p1,h2:p2 (primary first, "
                         "standby after) and fails over along it")
    ap.add_argument("--actor-base", type=int, default=0,
                    help="[actors] the first global actor slot here")
    ap.add_argument("--actor-count", type=int, default=8,
                    help="[actors] the actors to run here")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="[learner|learner-replica] where the learner, the "
                         "evaluator and local actors with a device backend "
                         "run; raises without a GPU unless cpu")
    ap.add_argument("--backend", choices=("process", "thread"),
                    default="process",
                    help="workers as spawn children or threads")
    ap.add_argument("--actor-backend", type=str, default=None,
                    choices=("inline", "pipelined", "batched", "device",
                             "anakin"),
                    help="the actors' schedule (factory."
                         "resolve_actor_backend): batched steps down to "
                         "pipelined on an actor host (no inference server "
                         "there); anakin runs the env fleet and the learner "
                         "as one loop on the learner host, and actor hosts "
                         "run the device schedule")
    ap.add_argument("--resume", type=str, default=None, metavar="REFS",
                    help="[learner] continue run REFS from its newest "
                         "complete checkpoint epoch; raises if there is "
                         "none.  Actor hosts re-attach by incarnation.")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="any Options override (repeatable); the same on "
                         "every host")
    ap.add_argument("--faults-client", type=str, default=None,
                    metavar="SPEC",
                    help="wire faults of this host's DCN clients "
                         "(utils/faults.py, e.g. 'sever@40,corrupt@90' or "
                         "'random:7'); exported as DCN_FAULTS_CLIENT")
    ap.add_argument("--faults-gateway", type=str, default=None,
                    metavar="SPEC",
                    help="[learner] the gateway's wire faults "
                         "(DCN_FAULTS_GATEWAY)")
    ap.add_argument("--reconnect-timeout", type=float, default=None,
                    help="seconds a disconnected actor redials before its "
                         "session is lost (DCN_RECONNECT_TIMEOUT)")
    ap.add_argument("--heartbeat", type=float, default=None,
                    help="idle seconds between heartbeat pings "
                         "(DCN_HEARTBEAT_INTERVAL; <= 0 turns them off)")
    return ap, ap.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    ap, args = parse_args(argv)
    if args.role in _UNPORTED_ROLES:
        from pytorch_distributed_tpu_torch.factory import _not_ported

        raise _not_ported(f"fleet role {args.role!r} (item 8)")
    for env, val in (("DCN_FAULTS_CLIENT", args.faults_client),
                     ("DCN_FAULTS_GATEWAY", args.faults_gateway),
                     ("DCN_RECONNECT_TIMEOUT", args.reconnect_timeout),
                     ("DCN_HEARTBEAT_INTERVAL", args.heartbeat)):
        if val is not None:
            os.environ[env] = str(val)
    overrides = parse_set_overrides(args.set)
    # the roles' placement: the learners on --device, the actor hosts and
    # the standby on the CPU
    overrides["device"] = (args.device if args.role in (
        "learner", "learner-replica") else "cpu")
    if args.num_actors is not None:
        overrides["num_actors"] = args.num_actors
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.actor_backend is not None:
        overrides["actor_backend"] = args.actor_backend
    if args.resume is not None:
        if args.role != "learner":
            ap.error("--resume applies to the learner host (actor hosts "
                     "re-attach through DCN incarnation fencing)")
        overrides["refs"] = args.resume
        overrides["resume"] = "must"
    opt = build_options(args.config, **overrides)
    if args.role == "learner":
        summary = run_fleet_learner(opt, local_actors=args.local_actors,
                                    port=args.port, backend=args.backend)
        print(json.dumps(summary), flush=True)
        return summary
    if not args.coordinator:
        ap.error(f"--role {args.role} needs --coordinator host:port")
    if args.role == "learner-replica":
        summary = run_replica_host(opt, args.coordinator, args.replica_id)
        print(json.dumps(summary), flush=True)
        return summary
    if args.role == "gateway-standby":
        summary = run_gateway_standby(opt, args.coordinator, args.port)
        print(json.dumps(summary), flush=True)
        return summary
    abandoned = run_fleet_actors(opt, args.coordinator, args.actor_base,
                                 args.actor_count, backend=args.backend)
    if abandoned:
        print(f"[fleet] actor host FAILED: slots {abandoned} out of "
              "restart budget", flush=True)
        sys.exit(1)
    return abandoned


if __name__ == "__main__":
    main()
