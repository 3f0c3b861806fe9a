"""The run topology — the port of pytorch_distributed_tpu/runtime.py
(``_child_main`` :53-98, ``Topology`` :101-352 with ``_worker_specs``
:201-226, ``run`` :228-352, ``_spawn`` :374, ``_join_all`` :510, and
``test``).

The shared plane (clocks, stat accumulators, the flat parameter store and
the ingest queue) is made here, and the actors' C++ stepper is built once
(``factory.prebuild_native``, reference :243); then one logger,
``num_actors`` actors and, when ``evaluator_nepisodes > 0``, one
evaluator run as workers, with the learner on the calling thread of this
process.

Backends:

- ``process`` (the reference's production topology): each worker is a
  spawn child that the trampoline pins to the CPU before anything in it
  resolves a device, so the learner's process is the only one with a CUDA
  context.  Each child reports whether CUDA was initialised in it when it
  exits; the summary's ``runtime/children_with_cuda`` counts them.  A
  monitor thread trips the stop event when a child exits abnormally, and
  ``run`` then raises.  The restart budget and the SIGTERM preemption
  path are not ported yet (ROADMAP.md).
- ``thread``: the same workers as threads of this process, over an
  in-process ``queue.Queue`` (built as such, where the reference swaps
  one in: ``_use_thread_queue`` :357-372).  The threads share one GIL
  with the learner, which is what bounds this backend (PERF.md).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from pytorch_distributed_tpu_torch.agents.actor import (
    resolve_actor_backend, run_dqn_actor,
)
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
    EnvSpec, build_memory, build_model, prebuild_native, probe_env,
    resolve_device,
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
    ``children_with_cuda`` if CUDA was initialised in it all the same."""
    enter_child(num_threads)
    args[0].device = "cpu"  # args[0] is this child's copy of the Options
    try:
        WORKERS[role](*args)
    finally:
        if torch.cuda.is_initialized():
            with children_with_cuda.get_lock():
                children_with_cuda.value += 1


def child_threads(opt: Options) -> int:
    """A child's share of the host's cores on the process backend: the
    cores over the processes that compute (the actors, the evaluator and
    the learner's)."""
    computing = opt.num_actors + 1 + (
        opt.agent_params.evaluator_nepisodes > 0)
    return max(1, (os.cpu_count() or 1) // computing)


class Topology:
    """Builds the shared plane and runs the worker topology for one
    Options."""

    def __init__(self, opt: Options, spec: Optional[EnvSpec] = None,
                 backend: str = "process"):
        if backend not in ("process", "thread"):
            raise ValueError(f"unknown backend {backend!r}")
        resolve_device(opt)  # fail before any worker starts
        resolve_actor_backend(opt)
        self.opt = opt
        self.backend = backend
        self.spec = spec if spec is not None else probe_env(opt)
        self.clock = GlobalClock()
        self.actor_stats = ActorStats()
        self.learner_stats = LearnerStats()
        self.evaluator_stats = EvaluatorStats()
        self.param_store = ParamStore(
            num_params(build_model(opt, self.spec).state_dict()))
        self.handles = build_memory(opt, self.spec,
                                    in_process=backend == "thread")
        self.children_with_cuda = _CTX.Value("l", 0)
        self._workers: List[Any] = []
        self._errors: List[str] = []

    def _worker_specs(self):
        opt, spec = self.opt, self.spec
        specs = [("logger", 0, (opt, self.clock, self.actor_stats,
                                self.learner_stats, self.evaluator_stats))]
        for i in range(opt.num_actors):
            # one feeder per actor: threads must not share a chunk buffer
            specs.append(("actor", i, (
                opt, spec, i, self.handles.actor_side.clone(),
                self.param_store, self.clock, self.actor_stats)))
        if opt.agent_params.evaluator_nepisodes > 0:
            specs.append(("evaluator", 0, (
                opt, spec, 0, None, self.param_store, self.clock,
                self.evaluator_stats)))
        else:
            # no evaluator: the logger's end-of-run drain must not wait
            self.evaluator_stats.done.value = 1
        return specs

    def run(self) -> Dict[str, float]:
        """Mode 1: start the workers, run the learner here, join.  Returns
        the learner's summary; raises if any worker failed."""
        opt = self.opt
        prebuild_native(opt)  # once, before N actors race one g++
        specs = self._worker_specs()
        threads_before = torch.get_num_threads()
        if self.backend == "process":
            threads = child_threads(opt)
            for role, ind, args in specs:
                self._spawn(role, ind, args, threads)
            self.handles.learner_side.close_write_end()
            torch.set_num_threads(threads)
            threading.Thread(target=self._monitor, name="monitor",
                             daemon=True).start()
        else:
            for role, ind, args in specs:
                t = threading.Thread(target=self._thread_main,
                                     args=(role, ind, args),
                                     name=f"{role}-{ind}", daemon=True)
                t.start()
                self._workers.append(t)
        failure = None
        try:
            summary = run_learner(opt, self.spec, 0,
                                  self.handles.learner_side,
                                  self.param_store, self.clock,
                                  self.learner_stats)
        except Exception as e:  # a dead worker can break the ingest too
            failure = e
        finally:
            self.clock.stop.set()  # releases every worker loop
            self._join_all()
            self.handles.learner_side.close()
            torch.set_num_threads(threads_before)
        if self._errors:
            raise RuntimeError(f"workers failed: {self._errors}") \
                from failure
        if failure is not None:
            raise failure
        summary["runtime/children_with_cuda"] = self.children_with_cuda.value
        return summary

    def _thread_main(self, role: str, ind: int, args: tuple) -> None:
        try:
            WORKERS[role](*args)
        except BaseException as e:  # surfaced by run() after the join
            self._errors.append(f"{role}-{ind}: {e!r}")
            self.clock.stop.set()
            raise

    def _spawn(self, role: str, ind: int, args: tuple, threads: int) -> None:
        p = _CTX.Process(target=_child_main,
                         args=(role, args, threads, self.children_with_cuda),
                         name=f"{role}-{ind}", daemon=True)
        p.start()
        self._workers.append(p)

    def _monitor(self, poll: float = 0.2) -> None:
        """Trip the stop event as soon as any child exits abnormally."""
        while not self.clock.stop.is_set():
            for p in self._workers:
                if p.exitcode not in (None, 0):
                    self._errors.append(f"{p.name} exited with code "
                                        f"{p.exitcode}")
                    print(f"[runtime] {p.name} died (exit code "
                          f"{p.exitcode}); stopping the run", flush=True)
                    self.clock.stop.set()
                    return
            time.sleep(poll)

    def _join_all(self, timeout: float = 240.0) -> None:
        """Join every worker within ``timeout`` (the evaluator's final
        evaluation can take a while), then terminate the stragglers."""
        deadline = time.monotonic() + timeout
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
                        e.startswith(w.name + " ") for e in self._errors):
                    self._errors.append(f"{w.name} exited with code "
                                        f"{w.exitcode}")


def train(opt: Options, backend: str = "process") -> Dict[str, float]:
    return Topology(opt, backend=backend).run()


def test(opt: Options) -> Dict[str, float]:
    """Mode 2: the tester, inline, on the run's device."""
    from pytorch_distributed_tpu_torch.agents.tester import run_tester

    return run_tester(opt, probe_env(opt))
