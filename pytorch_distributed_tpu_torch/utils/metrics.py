"""Metrics writer — the port of pytorch_distributed_tpu/utils/metrics.py
(``MetricsWriter`` :56-163, ``read_scalars``) as far as the logger needs
it: scalar rows appended to ``{log_dir}/scalars.jsonl`` in the
reference's row layout, ``{tag, value, step, wall}`` plus ``role`` and
``run_id`` when the writer knows them, under the reference's tag names
(``evaluator/avg_reward``, ``actor/total_nframes``,
``learner/critic_loss``, ...).  The TensorBoard mirror and the histogram,
bucket and span rows are not ported yet.

    python -m pytorch_distributed_tpu_torch.utils.metrics LOG_DIR

prints the run's actor timer phases (``timer_phases``) as one JSON line.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time
from typing import List, Optional


class MetricsWriter:
    def __init__(self, log_dir: str, role: Optional[str] = None,
                 run_id: Optional[str] = None):
        self.log_dir = log_dir
        self.role = role
        self.run_id = run_id
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a",
                           buffering=1)

    def _write(self, rec: dict) -> None:
        if self.role is not None:
            rec.setdefault("role", self.role)
        if self.run_id is not None:
            rec.setdefault("run_id", self.run_id)
        self._jsonl.write(json.dumps(rec) + "\n")

    def scalar(self, tag: str, value: float, step: int,
               wall: Optional[float] = None) -> None:
        self._write({"tag": tag, "value": float(value), "step": int(step),
                     "wall": wall if wall is not None else time.time()})

    def scalars(self, kv: dict, step: int,
                wall: Optional[float] = None) -> None:
        if wall is None:
            wall = time.time()
        for tag, value in kv.items():
            self.scalar(tag, value, step, wall)

    def flush(self) -> None:
        self._jsonl.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()


def read_scalars(log_dir: str) -> List[dict]:
    """Every row of a run dir's ``scalars.jsonl``; a line torn by a kill
    mid-write is skipped."""
    path = os.path.join(log_dir, "scalars.jsonl")
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out


def timer_phases(log_dir: str, prefix: str = "actor") -> dict:
    """A run's StepTimer rows (utils/profiling.py) summed over every worker
    of ``prefix`` and every window: ms per call of each phase, and ``tick``,
    the ms of one loop iteration (the phases it runs once: ``act``, or
    ``sync`` and ``dispatch``, then ``env`` and ``advance``; ``param_swap``
    spread over the iterations), with ``ticks``, their count."""
    total, calls = {}, {}
    pattern = re.compile(rf"{re.escape(prefix)}/time_(\w+?)_(total_ms|calls)")
    for r in read_scalars(log_dir):
        m = pattern.fullmatch(r["tag"])
        if m:
            acc = total if m[2] == "total_ms" else calls
            acc[m[1]] = acc.get(m[1], 0.0) + r["value"]
    out = {p: total[p] / calls[p] for p in total if calls.get(p)}
    ticks = calls.get("env", 0.0)
    if ticks:
        parts = ("sync", "dispatch") if "sync" in total else ("act",)
        out["tick"] = sum(total.get(p, 0.0) for p in (
            *parts, "env", "advance", "param_swap")) / ticks
        out["ticks"] = ticks
    return out


if __name__ == "__main__":
    print(json.dumps(timer_phases(sys.argv[1])))
