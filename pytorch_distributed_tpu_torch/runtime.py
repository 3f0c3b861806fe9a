"""The run topology — the port of pytorch_distributed_tpu/runtime.py
(``_child_main`` :53-98, ``Topology`` :101-352 with ``_worker_specs``
:201-226, ``run`` :228-352, ``_spawn`` :374, ``_monitor`` :384-508,
``_join_all`` :510-546, and ``test``).

The shared plane (clocks, stat accumulators, the flat parameter store,
the ingest queues and the hang watchdog's progress board, attached to
the clock) is made here, and the actors' C++ stepper is built once
(``factory.prebuild_native``, reference :243); then one logger,
``num_actors`` actors and, when ``evaluator_nepisodes > 0``, one
evaluator run as workers, with the learner on the calling thread of this
process.  Under ``actor_backend=anakin`` (``factory.anakin_active``) no
actor worker exists: the learner's process runs the env fleet and the
learner as one loop (agents/anakin.py, reference :188-205, :314-330),
and the logger, the evaluator, the monitor, the hang watchdog and
SIGTERM stay as they are.  With ``actor_backend=batched`` the shared inference server
(agents/inference.py) runs as a thread of this process too: built here,
a client handed to each actor, started after the workers and before the
learner, stopped after the workers' join (an actor may still wait in
``collect``), and watched by the monitor on both backends: a dead server
stops the run and ``run`` raises.  Its counts land in the summary as
``inference/*``.

Backends:

- ``process`` (the reference's production topology): each worker is a
  spawn child that the trampoline pins to the CPU before anything in it
  resolves a device, so the learner's process is the only one with a CUDA
  context.  Each child reports whether CUDA was initialised in it when it
  exits; the summary's ``runtime/children_with_cuda`` counts them.  Each
  actor slot feeds a queue of its own (memory/device_replay.py).  A
  monitor thread supervises the children: a dead actor is respawned with
  the same arguments, a fresh slot queue and, under ``batched``, a fresh
  pair of inference pipes, up to ``max_restarts`` (3)
  times per slot (utils/supervision.py ``RestartBudget``); a dead logger
  or evaluator, or an actor out of budget, stops the run and ``run``
  raises.  With ``hang_deadline > 0`` the monitor is also the hang
  watchdog: a child whose progress marks go stale is SIGKILLed and
  respawned under the same budget (``runtime/hang_kills``), and a stale
  learner ends the process with ``EXIT_HUNG`` for an outer supervisor
  to resume.
- ``thread``: the same workers as threads of this process, over one
  in-process ``queue.Queue`` (built as such, where the reference swaps
  one in: ``_use_thread_queue`` :357-372), with no restarts.  The threads
  share one GIL with the learner, which is what bounds this backend
  (PERF.md).

SIGTERM is a preemption notice on either backend when ``run`` is called
from the main thread: the run drains, the learner commits its final
checkpoint epoch, and ``run`` returns with ``runtime/preempted`` 1.

The flight recorder (utils/flight_recorder.py, reference :71-97,
:244-282, :394-505): ``run`` makes ``{log_dir}`` the process's blackbox
home and exports it, with the run id, to the spawn children; a child
records its crash and dumps its rings before re-raising; the supervisor
records and dumps (into ``runtime.jsonl``) a dead inference server, each
worker restarted or fatal, each hung worker before its SIGKILL, a hung
learner before the exit, and the SIGTERM notice before the drain.  The
watchdog reads ``HealthParams`` through ``health.resolve``, so
``TPU_APEX_HEALTH_HANG_DEADLINE`` and its siblings apply.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from pytorch_distributed_tpu_torch.agents.actor import run_dqn_actor
from pytorch_distributed_tpu_torch.agents.clocks import (
    ActorStats, EvaluatorStats, GlobalClock, LearnerStats,
)
from pytorch_distributed_tpu_torch.agents.evaluator import run_evaluator
from pytorch_distributed_tpu_torch.agents.learner import run_learner
from pytorch_distributed_tpu_torch.agents.logger import run_logger
from pytorch_distributed_tpu_torch.agents.param_store import (
    ParamStore, num_params,
)
from pytorch_distributed_tpu_torch.config import Options
from pytorch_distributed_tpu_torch.factory import (
    EnvSpec, anakin_active, build_memory, build_model,
    needs_inference_server, prebuild_native, probe_env,
    resolve_actor_backend, resolve_device,
)
from pytorch_distributed_tpu_torch.utils import flight_recorder, health
from pytorch_distributed_tpu_torch.utils.supervision import (
    EXIT_HUNG, ProgressBoard, RestartBudget, describe_exit,
)

_CTX = mp.get_context("spawn")

WORKERS: Dict[str, Callable] = {
    "logger": run_logger,
    "actor": run_dqn_actor,
    "evaluator": run_evaluator,
}


def enter_child(num_threads: int) -> None:
    """What every spawn child does before its worker: hide every GPU and
    take its share of the host's cores."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch.set_num_threads(num_threads)


def _child_main(role: str, args: tuple, num_threads: int,
                children_with_cuda) -> None:
    """Spawn trampoline: ``enter_child``, set the run's device to the CPU
    before the worker resolves one, run the worker, and count the child in
    ``children_with_cuda`` if CUDA was initialised in it all the same.  A
    worker's exception is recorded and every ring dumped before it
    propagates, so the respawn erases nothing."""
    enter_child(num_threads)
    opt = args[0]  # this child's copy of the Options
    opt.device = "cpu"
    flight_recorder.configure(opt.log_dir, run_id=opt.refs)
    label = role
    if role in ("actor", "evaluator") and len(args) > 2:
        label = f"{role}-{args[2]}"
    try:
        WORKERS[role](*args)
    except BaseException as e:
        flight_recorder.get_recorder(label).record("crash", error=repr(e))
        flight_recorder.dump_all(f"{label} crashed: {e!r}")
        raise
    finally:
        if torch.cuda.is_initialized():
            with children_with_cuda.get_lock():
                children_with_cuda.value += 1


def child_threads(opt: Options) -> int:
    """A child's share of the host's cores on the process backend: the
    cores over the processes that compute (the actors, the evaluator and
    the learner's)."""
    actors = 0 if anakin_active(opt) else opt.num_actors
    computing = actors + 1 + (opt.agent_params.evaluator_nepisodes > 0)
    return max(1, (os.cpu_count() or 1) // computing)


class Topology:
    """Builds the shared plane and runs the worker topology for one
    Options."""

    def __init__(self, opt: Options, spec: Optional[EnvSpec] = None,
                 backend: str = "process", max_restarts: int = 3):
        if backend not in ("process", "thread"):
            raise ValueError(f"unknown backend {backend!r}")
        resolve_device(opt)  # fail before any worker starts
        self.opt = opt
        self.backend = backend
        self.spec = spec if spec is not None else probe_env(opt)
        self.clock = GlobalClock()
        self.actor_stats = ActorStats()
        self.learner_stats = LearnerStats()
        self.evaluator_stats = EvaluatorStats()
        self.param_store = ParamStore(
            num_params(build_model(opt, self.spec,
                                   init_weights=False).state_dict()))
        self.handles = build_memory(opt, self.spec,
                                    in_process=backend == "thread")
        self.inference_server = None
        if needs_inference_server(opt):
            from pytorch_distributed_tpu_torch.agents.inference import (
                InferenceServer,
            )

            self.inference_server = InferenceServer(
                opt, self.spec, self.param_store,
                in_process=backend == "thread")
        resolve_actor_backend(opt, self.inference_server)
        # under anakin the env fleet lives in the learner's process: no
        # actor worker, and no actor slot on the watchdog's board
        self.anakin = anakin_active(opt)
        self.children_with_cuda = _CTX.Value("l", 0)
        # the hang watchdog's board rides the clock's pickle into every
        # child, so it exists before any spawn
        self.progress_board = ProgressBoard(
            ["learner", "evaluator-0"]
            + [f"actor-{i}" for i in range(self._num_actor_workers())])
        self.clock.progress = self.progress_board
        self.health = health.resolve(opt.health_params)
        self.recorder = flight_recorder.get_recorder("runtime")
        self.max_restarts = max_restarts
        self.restarts = 0
        self.hang_kills = 0
        self._last_kill = float("-inf")  # the watchdog's newest kill
        # set when a SIGTERM (a preemption notice) ended the run
        self.preempted = threading.Event()
        self._workers: List[Any] = []
        self._meta: Dict[Any, tuple] = {}  # process -> (role, ind, args)
        self._errors: List[str] = []
        self._threads = 1

    def _num_actor_workers(self) -> int:
        return 0 if self.anakin else self.opt.num_actors

    def _worker_specs(self):
        opt, spec = self.opt, self.spec
        specs = [("logger", 0, (opt, self.clock, self.actor_stats,
                                self.learner_stats, self.evaluator_stats))]
        for i in range(self._num_actor_workers()):
            # one feeder per actor slot: its own queue on the process
            # backend, its own chunk buffer on the thread backend
            srv = self.inference_server
            specs.append(("actor", i, (
                opt, spec, i, self.handles.learner_side.make_feeder(i),
                self.param_store, self.clock, self.actor_stats,
                srv.make_client(i) if srv is not None else None)))
        if opt.agent_params.evaluator_nepisodes > 0:
            specs.append(("evaluator", 0, (
                opt, spec, 0, None, self.param_store, self.clock,
                self.evaluator_stats)))
        else:
            # no evaluator: the logger's end-of-run drain must not wait
            self.evaluator_stats.done.value = 1
        return specs

    def _watch_sigterm(self, run_over: threading.Event):
        """On the main thread: make SIGTERM a preemption notice.  The
        handler only sets ``preempted`` (a ``threading.Event``); a watcher
        thread sets the shared stop event, since the interrupted thread
        (the learner) polls that event's lock and a set from inside the
        handler could deadlock on it (reference :253-287).  Returns the
        previous handler, or None when none was installed."""
        if threading.current_thread() is not threading.main_thread():
            return None
        prev = signal.signal(signal.SIGTERM,
                             lambda signum, frame: self.preempted.set())

        def promote():
            while not run_over.is_set():
                if self.preempted.wait(0.2):
                    print("[runtime] SIGTERM: preemption notice; draining "
                          "for a final checkpoint epoch", flush=True)
                    self.recorder.record("sigterm-preemption")
                    flight_recorder.dump_all("SIGTERM preemption notice")
                    self.clock.stop.set()
                    return

        threading.Thread(target=promote, name="preempt-watch",
                         daemon=True).start()
        return prev

    def run(self) -> Dict[str, float]:
        """Mode 1: start the workers, run the learner here, supervise,
        join.  Returns the learner's summary with the runtime's counts;
        raises if any worker failed for good."""
        opt = self.opt
        prebuild_native(opt)  # once, before N actors race one g++
        # the run's blackbox home, exported so spawn children inherit it
        flight_recorder.configure(opt.log_dir, export_env=True,
                                  run_id=opt.refs)
        specs = self._worker_specs()
        threads_before = torch.get_num_threads()
        run_over = threading.Event()
        prev_term = self._watch_sigterm(run_over)
        monitor = None
        if self.backend == "process":
            self._threads = child_threads(opt)
            for role, ind, args in specs:
                self._spawn(role, ind, args)
            torch.set_num_threads(self._threads)
        else:
            for role, ind, args in specs:
                t = threading.Thread(target=self._thread_main,
                                     args=(role, ind, args),
                                     name=f"{role}-{ind}", daemon=True)
                t.start()
                self._workers.append(t)
        if self.backend == "process" or self.inference_server is not None:
            monitor = threading.Thread(target=self._monitor, name="monitor",
                                       daemon=True)
            monitor.start()
        failure = None
        try:
            if self.inference_server is not None:
                # after the clients were wired, before anything acts
                self.inference_server.start()
            self.progress_board.note_start("learner")
            if self.anakin:
                # the learner is the actor fleet too; the shared
                # ActorStats keep the logger's actor rows flowing
                from pytorch_distributed_tpu_torch.agents.anakin import (
                    run_anakin_learner,
                )

                summary = run_anakin_learner(
                    opt, self.spec, 0, self.handles.learner_side,
                    self.param_store, self.clock, self.learner_stats,
                    actor_stats=self.actor_stats)
            else:
                summary = run_learner(opt, self.spec, 0,
                                      self.handles.learner_side,
                                      self.param_store, self.clock,
                                      self.learner_stats)
        except Exception as e:  # a dead worker can break the ingest too
            failure = e
        finally:
            self.clock.stop.set()  # releases every worker loop
            run_over.set()  # parks the preemption watcher
            if prev_term is not None:
                signal.signal(signal.SIGTERM, prev_term)
            if monitor is not None:
                monitor.join()  # no respawn races the join below
            self._join_all()
            if self.inference_server is not None:
                # after the join: an actor may still wait in collect
                self._note_server_death()
                self.inference_server.stop()
            self.handles.learner_side.close()
            torch.set_num_threads(threads_before)
        if self._errors:
            raise RuntimeError(f"workers failed: {self._errors}") \
                from failure
        if failure is not None:
            raise failure
        summary.update({
            "runtime/children_with_cuda": self.children_with_cuda.value,
            "runtime/restarts": self.restarts,
            "runtime/hang_kills": self.hang_kills,
            "runtime/preempted": int(self.preempted.is_set()),
            # the actors' env steps once every worker has stopped (the
            # learner's "actor/steps" is read before the join)
            "runtime/actor_steps": self.clock.actor_step.value})
        if self.inference_server is not None:
            summary.update({f"inference/{k}": v for k, v in
                            self.inference_server.stats.items()})
        return summary

    def _thread_main(self, role: str, ind: int, args: tuple) -> None:
        try:
            WORKERS[role](*args)
        except BaseException as e:  # surfaced by run() after the join
            self._errors.append(f"{role}-{ind}: {e!r}")
            self.clock.stop.set()
            raise

    def _spawn(self, role: str, ind: int, args: tuple) -> None:
        p = _CTX.Process(target=_child_main,
                         args=(role, args, self._threads,
                               self.children_with_cuda),
                         name=f"{role}-{ind}", daemon=True)
        p.start()
        # the incarnation's start-up grace window starts here
        self.progress_board.note_start(p.name)
        if role == "actor":
            # the child holds its own write end now; and a read that
            # ends in EOF is judged by this child's liveness
            ingest = self.handles.learner_side
            ingest.bind_producer(ind, p.sentinel)
            ingest.close_write_end(ind)
            if self.inference_server is not None:
                self.inference_server.close_client_ends(ind)
        self._workers.append(p)
        self._meta[p] = (role, ind, args)

    def _replace(self, p, code: int, budget: RestartBudget) -> bool:
        """After child ``p`` died with ``code``: respawn it if it is an
        actor with budget left (a fresh slot queue, the same arguments
        otherwise) and return True; else record the failure, stop the
        run and return False (``p`` stays for ``_join_all``)."""
        role, ind, args = self._meta.pop(p)
        if role == "actor" and budget.request_restart(ind) is not None:
            self._workers.remove(p)
            budget.note_birth(ind)
            print(f"[runtime] actor-{ind} died ({describe_exit(code)}); "
                  f"restart {budget.count(ind)}/{budget.max_restarts}",
                  flush=True)
            self.recorder.record("worker-restarted", role=role, slot=ind,
                                 exit=code, restarts=budget.count(ind))
            flight_recorder.dump_all(f"actor-{ind} died "
                                     f"({describe_exit(code)}); restarted")
            feeder = self.handles.learner_side.replace_slot(ind)
            srv = self.inference_server
            client = srv.replace_client(ind) if srv is not None else None
            self._spawn(role, ind, args[:3] + (feeder,) + args[4:7]
                        + (client,))
            # counted once the new child is listed and its marks reset
            self.restarts += 1
            return True
        self._errors.append(f"{role}-{ind} {describe_exit(code)}")
        print(f"[runtime] {role}-{ind} died ({describe_exit(code)}); "
              f"stopping the run", flush=True)
        self.recorder.record("worker-fatal", role=role, slot=ind, exit=code)
        flight_recorder.dump_all(f"{role}-{ind} died ({describe_exit(code)}); "
                                 f"run stopped")
        self.clock.stop.set()
        return False

    def _monitor(self, poll: float = 0.2) -> None:
        """Stop the run if the inference server died (checked first, on
        both backends: a dead server would turn every actor respawn into
        a ``collect`` timeout); on the process backend, supervise the
        children (``_supervise``)."""
        hp = self.health
        budget = RestartBudget(max_restarts=self.max_restarts)
        for role, ind, _args in self._meta.values():
            if role == "actor":
                budget.note_birth(ind)
        srv = self.inference_server
        while not self.clock.stop.is_set():
            if srv is not None and not srv.healthy():
                self._note_server_death()
                print("[runtime] inference server died; stopping the run",
                      flush=True)
                self.recorder.record("inference-server-dead")
                flight_recorder.dump_all("inference server died; run "
                                         "stopped")
                self.clock.stop.set()
                return
            if self.backend == "process" and not self._supervise(budget,
                                                                 hp):
                return
            time.sleep(poll)

    def _note_server_death(self) -> None:
        """Record the inference server's failure once, if it failed (the
        actors' own errors may have stopped the run first)."""
        err = self.inference_server.error
        msg = f"inference server died: {err!r}"
        if err is not None and msg not in self._errors:
            self._errors.append(msg)

    def _supervise(self, budget: RestartBudget, hp) -> bool:
        """One pass over the children: respawn dead actors within their
        budget, stop the run on any other death; with ``hang_deadline >
        0``, SIGKILL and respawn stale children the same way
        (``EXIT_HUNG``) and end the process if the learner is stale.
        False once the run is stopped."""
        for p in list(self._workers):
            if p.exitcode not in (None, 0) \
                    and not self._replace(p, p.exitcode, budget):
                return False
        if hp.hang_deadline > 0:
            hung = set(self.progress_board.hung(hp.hang_deadline,
                                                hp.hang_grace))
            for p in list(self._workers):
                if p.name not in hung or p.exitcode is not None:
                    continue
                age = self.progress_board.age(p.name)
                print(f"[runtime] {p.name} made no progress for "
                      f"{age:.1f} s; killing it", flush=True)
                self.hang_kills += 1
                role, ind, _args = self._meta[p]
                self.recorder.record("worker-hung", role=role, slot=ind,
                                     age=round(age, 1))
                flight_recorder.dump_all(
                    f"{p.name} hung (> {hp.hang_deadline:g}s without "
                    f"progress); watchdog SIGKILL")
                p.kill()
                p.join(5.0)
                self._last_kill = time.monotonic()
                if not self._replace(p, EXIT_HUNG, budget):
                    return False
            # a learner reading a hung child's pipe goes stale with it,
            # and reads on once the kill ends the pipe: it is judged only
            # once a whole deadline has passed since the last kill, so a
            # busy host's slow wake-up is not taken for a hang
            if "learner" in hung and (time.monotonic() - self._last_kill
                                      > hp.hang_deadline):
                print(f"[runtime] learner ({describe_exit(EXIT_HUNG)}); "
                      f"ending the process for a resume", flush=True)
                self.recorder.record("learner-hung")
                flight_recorder.dump_all(
                    f"learner hung (> {hp.hang_deadline:g}s without "
                    f"progress); failing host fast")
                self.clock.stop.set()
                os._exit(EXIT_HUNG)
        return True

    def _join_all(self, timeout: float = 240.0) -> None:
        """Join every worker within ``timeout`` (the evaluator's final
        evaluation can take a while), then terminate the stragglers.  With
        the watchdog on, a child whose marks are stale at shutdown can
        drain nothing: it is killed at once (an actor's kill is counted
        in ``hang_kills``, any other child's is a failure)."""
        deadline = time.monotonic() + timeout
        hp = self.health
        stale_killed = set()
        while hp.hang_deadline > 0 and time.monotonic() < deadline:
            alive = [w for w in self._workers
                     if isinstance(w, _CTX.Process) and w.is_alive()]
            if not alive:
                break
            hung = set(self.progress_board.hung(hp.hang_deadline,
                                                hp.hang_grace))
            for w in alive:
                if w.name in hung:
                    print(f"[runtime] {w.name} hung at shutdown; killing "
                          f"it", flush=True)
                    w.kill()  # SIGTERM would wait on a stopped child
                    w.join(5.0)
                    stale_killed.add(w.name)
                    if w.name.startswith("actor-"):
                        self.hang_kills += 1
            time.sleep(0.25)
        # the logger last: its end-of-run drain waits for the evaluator,
        # which a dead evaluator must not leave it doing
        for w in sorted(self._workers, key=lambda w: w.name == "logger-0"):
            w.join(max(0.1, deadline - time.monotonic()))
            if w.name == "evaluator-0":
                self.evaluator_stats.done.value = 1
        for w in self._workers:
            if isinstance(w, _CTX.Process):
                if w.is_alive():
                    print(f"[runtime] {w.name} still running after the "
                          f"join; terminating it", flush=True)
                    w.terminate()
                    w.join(5.0)
                    self._errors.append(f"{w.name} did not stop")
                elif w.exitcode != 0 and not any(
                        e.startswith(w.name + " ") for e in self._errors) \
                        and not (w.name in stale_killed
                                 and w.name.startswith("actor-")):
                    self._errors.append(f"{w.name} exited with code "
                                        f"{w.exitcode}")


def train(opt: Options, backend: str = "process") -> Dict[str, float]:
    return Topology(opt, backend=backend).run()


def test(opt: Options) -> Dict[str, float]:
    """Mode 2: the tester, inline, on the run's device."""
    from pytorch_distributed_tpu_torch.agents.tester import run_tester

    return run_tester(opt, probe_env(opt))
