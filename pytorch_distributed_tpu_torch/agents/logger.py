"""Logger worker: metrics aggregation — the port of
pytorch_distributed_tpu/agents/logger.py ``run_logger`` (:24-117).

Workers push into the shared accumulators (agents/clocks.py) and this
worker drains them: evaluator scalars whenever the handshake flag is
raised, actor and learner accumulators every ``logger_freq`` seconds,
every scalar against the global learner step, under the reference's tag
names (utils/metrics.py).  After the run ends it keeps draining until the
evaluator's final point has landed (or a grace just under the join's
timeout has passed) and the late fragments have stopped arriving, and
writes them as one final row group.
"""

from __future__ import annotations

import time

from pytorch_distributed_tpu_torch.agents.clocks import (
    ActorStats, EvaluatorStats, GlobalClock, LearnerStats,
)
from pytorch_distributed_tpu_torch.config import Options
from pytorch_distributed_tpu_torch.utils.metrics import MetricsWriter


def run_logger(opt: Options, clock: GlobalClock, actor_stats: ActorStats,
               learner_stats: LearnerStats,
               evaluator_stats: EvaluatorStats) -> None:
    ap = opt.agent_params
    writer = MetricsWriter(opt.log_dir, role="logger", run_id=opt.refs)
    last_drain = time.monotonic()
    finished_at = None
    closing_at = None
    quiescent = 0
    final_a: dict = {}
    final_le: dict = {}

    def write_group(a: dict, le: dict) -> None:
        step = clock.learner_step.value
        if a["nepisodes"] > 0:  # reference logger.py:69-78
            writer.scalars({
                "actor/avg_steps": a["total_steps"] / a["nepisodes"],
                "actor/avg_reward": a["total_reward"] / a["nepisodes"],
                "actor/nepisodes_solved": a["nepisodes_solved"],
            }, step=step)
        if a["total_nframes"] > 0:
            writer.scalar("actor/total_nframes", a["total_nframes"],
                          step=step)
        if le["counter"] > 0:  # reference logger.py:79-89
            writer.scalars({
                "learner/critic_loss": le["critic_loss"] / le["counter"],
                "learner/actor_loss": le["actor_loss"] / le["counter"],
                "learner/q_mean": le["q_mean"] / le["counter"],
                "learner/grad_norm": le["grad_norm"] / le["counter"],
                "learner/steps_per_sec": le["steps_per_sec"] / le["counter"],
                "learner/moe_aux": le["moe_aux"] / le["counter"],
            }, step=step)
        writer.flush()

    try:
        while True:
            finished = clock.done(ap.steps)
            if finished and finished_at is None:
                finished_at = time.monotonic()
            # the grace sits under runtime._join_all's 240 s timeout
            closing = finished and (
                evaluator_stats.done.value
                or time.monotonic() - finished_at > 230.0)
            if closing and closing_at is None:
                closing_at = time.monotonic()
            time.sleep(0.2)

            got = evaluator_stats.consume()
            if got is not None:
                # rows carry the capture wall time of the evaluated weights
                at_step, at_wall, ev = got
                writer.scalars({
                    "evaluator/avg_steps": ev["avg_steps"],
                    "evaluator/avg_reward": ev["avg_reward"],
                    "evaluator/nepisodes": ev["nepisodes"],
                    "evaluator/nepisodes_solved": ev["nepisodes_solved"],
                }, step=at_step, wall=at_wall or None)

            if closing:
                # workers flush their accumulators on their way out, which
                # can land after the end is seen here: keep draining until
                # two drains in a row bring nothing and 2 s have passed,
                # and merge the fragments into one final row group
                a, le = actor_stats.drain(), learner_stats.drain()
                arrived = (got is not None or a["nepisodes"] > 0
                           or a["total_nframes"] > 0 or le["counter"] > 0)
                for k, v in a.items():
                    final_a[k] = final_a.get(k, 0.0) + v
                for k, v in le.items():
                    final_le[k] = final_le.get(k, 0.0) + v
                quiescent = 0 if arrived else quiescent + 1
                if quiescent >= 2 and time.monotonic() - closing_at >= 2.0:
                    write_group(final_a, final_le)
                    break
            elif time.monotonic() - last_drain >= ap.logger_freq:
                last_drain = time.monotonic()
                write_group(actor_stats.drain(), learner_stats.drain())
    finally:
        writer.close()
