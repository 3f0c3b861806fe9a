"""Metrics writer — the port of pytorch_distributed_tpu/utils/metrics.py
(``MetricsWriter`` :56-163, ``read_scalars``) as far as the logger needs
it: scalar rows appended to ``{log_dir}/scalars.jsonl`` in the
reference's row layout, ``{tag, value, step, wall}`` plus ``role`` and
``run_id`` when the writer knows them, under the reference's tag names
(``evaluator/avg_reward``, ``actor/total_nframes``,
``learner/critic_loss``, ...).  The TensorBoard mirror and the histogram,
bucket and span rows are not ported yet.
"""

from __future__ import annotations

import json
import os
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
