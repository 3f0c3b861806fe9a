"""The run topology — the port of pytorch_distributed_tpu/runtime.py
``Topology`` (:101-352), thread backend only: actors run as threads of
this process, the learner runs on the calling thread, and the ingest
queue, the parameter store and the clocks are plain in-process objects.
The process backend, the evaluator and the logger are not ported yet.

The threads share one GIL, and every torch call gives it up while it runs
and waits for it after; beside busy actor threads that wait is what the
learner's loop spends most of its time on (PERF.md), which is why the
learner replays its update from a CUDA graph on the GPU.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from pytorch_distributed_tpu_torch.agents.actor import (
    resolve_actor_backend, run_dqn_actor,
)
from pytorch_distributed_tpu_torch.agents.clocks import ActorStats, GlobalClock
from pytorch_distributed_tpu_torch.agents.learner import run_learner
from pytorch_distributed_tpu_torch.agents.param_store import ParamStore
from pytorch_distributed_tpu_torch.config import Options
from pytorch_distributed_tpu_torch.factory import (
    EnvSpec, build_memory, probe_env, resolve_device,
)


class Topology:
    def __init__(self, opt: Options, spec: Optional[EnvSpec] = None):
        resolve_device(opt)  # fail before any worker starts
        resolve_actor_backend(opt)
        self.opt = opt
        self.spec = spec if spec is not None else probe_env(opt)
        self.clock = GlobalClock()
        self.actor_stats = ActorStats()
        self.param_store = ParamStore()
        self.handles = build_memory(opt, self.spec)
        self._errors: List[BaseException] = []

    def _actor_main(self, ind: int) -> None:
        try:
            run_dqn_actor(self.opt, self.spec, ind,
                          self.handles.actor_side.clone(), self.param_store,
                          self.clock, self.actor_stats)
        except BaseException as e:  # surfaced by run() after the join
            self._errors.append(e)
            self.clock.stop.set()

    def run(self, backend: str = "thread") -> Dict[str, float]:
        if backend != "thread":
            raise NotImplementedError(
                f"backend {backend!r} is not ported yet (ROADMAP.md Queue "
                f"A item 5); use --backend thread")
        workers = [threading.Thread(target=self._actor_main, args=(i,),
                                    name=f"actor-{i}", daemon=True)
                   for i in range(self.opt.num_actors)]
        for t in workers:
            t.start()
        try:
            summary = run_learner(self.opt, self.spec, 0,
                                  self.handles.learner_side,
                                  self.param_store, self.clock)
        finally:
            self.clock.stop.set()  # releases every actor loop
            for t in workers:
                t.join(timeout=60.0)
        if self._errors:
            raise RuntimeError("an actor failed") from self._errors[0]
        summary.update({f"actor/{k}": v
                        for k, v in self.actor_stats.read().items()})
        return summary


def train(opt: Options, backend: str = "thread") -> Dict[str, float]:
    return Topology(opt).run(backend)
