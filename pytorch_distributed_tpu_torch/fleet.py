"""The fleet: one learner host and actor hosts over the DCN wire — the
port of pytorch_distributed_tpu/fleet.py's single-gateway part:
``FleetTopology`` (:77-363, without the profile and metrics providers,
the replica registry and the HA plane), ``run_fleet_learner``
(:365-372), ``_remote_actor_main`` (:640-725), ``run_fleet_actors``
(:728-956, without its ``MetricsPusher``) and ``main`` (:963-1093) with
the roles ``learner`` and ``actors``.

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

The roles ``learner-replica``, ``gateway-standby`` and ``replay-shard``,
and the reference's ``ReplicaParams``, ``GatewayParams`` and
``ShardParams`` fields, are not ported (ROADMAP.md Queue A item 8).
"""

from __future__ import annotations

import argparse
import dataclasses
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
            flow_params=self.flow,
            pressure=self._flow_pressure,
            flow_writer=(self.mission._writer
                         if self.mission is not None else None))

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
    return summary


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
          f"{client.reconnects}, faults {client.faults_injected})",
          flush=True)


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
    from pytorch_distributed_tpu_torch.utils import flight_recorder, health
    from pytorch_distributed_tpu_torch.utils.supervision import (
        EXIT_CRASH, EXIT_HUNG, ProgressBoard, RestartBudget, describe_exit,
    )

    prebuild_native(opt)  # once, before the workers race one g++
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
    return abandoned


# -- the CLI -----------------------------------------------------------------------

_UNPORTED_ROLES = ("learner-replica", "gateway-standby", "replay-shard")


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(
        prog="pytorch_distributed_tpu_torch.fleet",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--role", choices=("learner", "actors")
                    + _UNPORTED_ROLES, required=True,
                    help="learner: the learner host (the learner on the "
                         "card unless --device cpu, its gateway, its local "
                         "actors); actors: an actor host, whose actors run "
                         "their policies on the CPU (a remote actor host "
                         "is a CPU-only host, as in the reference); the "
                         "other roles are not ported")
    ap.add_argument("--config", type=int, default=1)
    ap.add_argument("--num-actors", type=int, default=None,
                    help="the fleet's actor count over every host "
                         "(default: the config's)")
    ap.add_argument("--port", type=int, default=5555,
                    help="[learner] the gateway's port (0: any free one)")
    ap.add_argument("--local-actors", type=int, default=0,
                    help="[learner] actors on the learner host")
    ap.add_argument("--coordinator", type=str, default=None,
                    help="[actors] the learner host as host:port (or an "
                         "ordered list h1:p1,h2:p2)")
    ap.add_argument("--actor-base", type=int, default=0,
                    help="[actors] the first global actor slot here")
    ap.add_argument("--actor-count", type=int, default=8,
                    help="[actors] the actors to run here")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="[learner] where the learner, the evaluator and "
                         "local actors with a device backend run; raises "
                         "without a GPU unless cpu")
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
    overrides["device"] = args.device if args.role == "learner" else "cpu"
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
        import json

        summary = run_fleet_learner(opt, local_actors=args.local_actors,
                                    port=args.port, backend=args.backend)
        print(json.dumps(summary), flush=True)
        return summary
    if not args.coordinator:
        ap.error("--role actors needs --coordinator host:port")
    abandoned = run_fleet_actors(opt, args.coordinator, args.actor_base,
                                 args.actor_count, backend=args.backend)
    if abandoned:
        print(f"[fleet] actor host FAILED: slots {abandoned} out of "
              "restart budget", flush=True)
        sys.exit(1)
    return abandoned


if __name__ == "__main__":
    main()
