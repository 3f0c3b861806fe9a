"""Metrics writer — the port of pytorch_distributed_tpu/utils/metrics.py:
``summarize_histogram`` (:39-53), ``MetricsWriter`` (:56-163) with its
TensorBoard mirror, ``ScalarsTail`` (:165-227), ``is_scalar_row``
(:230-238) and ``read_scalars`` (:241-260).  Rows are appended to ``{log_dir}/scalars.jsonl`` in the
reference's layout, under the reference's tag names
(``evaluator/avg_reward``, ``actor/total_nframes``,
``learner/critic_loss``, ...), each with ``role`` and ``run_id`` when the
writer knows them.  Three row kinds share the file, told apart by
``kind`` (a scalar row has none):

- scalar     ``{tag, value, step, wall}``;
- histogram  ``{tag, kind: "histogram", count, mean, p50, p95, max, step,
  wall}``, nearest-rank percentiles; TensorBoard gets
  ``<tag>/p50|p95|max``;
- buckets    ``{tag, kind: "buckets", counts, log10_lo, log10_hi, step,
  wall, ...}``, a distribution bucketed at its source (the PER X-ray);
- span       ``{tag, kind: "span", span, role, trace_id, value, step,
  wall}``, one sampled trace event (utils/tracing.py).

Buckets and spans go to the JSONL only.  The TensorBoard mirror
(``enable_tensorboard``) is best effort, as in the reference: without the
``tensorboard`` package the writer keeps the JSONL alone.  Where the
reference writes through ``torch.utils.tensorboard`` (which imports
TensorFlow when it is installed, seconds of start-up in the logger's
process), the port writes the same event file with the ``tensorboard``
package's record writer and protos alone (``_EventFile``).
``read_scalars`` and ``timer_phases`` read scalar rows only
(``is_scalar_row``); ``read_rows`` returns every row; ``ScalarsTail``
reads the rows appended since its last poll (mission control,
utils/telemetry.py).

    python -m pytorch_distributed_tpu_torch.utils.metrics LOG_DIR

prints the run's actor timer phases (``timer_phases``) as one JSON line.
"""

from __future__ import annotations

import json
import math
import os
import re
import socket
import sys
import time
from typing import Dict, List, Optional, Sequence


def summarize_histogram(values: Sequence[float]) -> Dict[str, float]:
    """count/mean/p50/p95/max of a sample set, nearest-rank percentiles
    (an observed value, no interpolation)."""
    vals = sorted(float(v) for v in values)
    n = len(vals)
    if n == 0:
        raise ValueError("summarize_histogram of an empty sample")

    def pct(q: float) -> float:
        return vals[min(n - 1, max(0, math.ceil(q * n) - 1))]

    return {"count": n, "mean": sum(vals) / n,
            "p50": pct(0.50), "p95": pct(0.95), "max": vals[-1]}


class _EventFile:
    """One TensorBoard event file (``events.out.tfevents.*``): a version
    record, then a scalar ``Summary`` per ``add_scalar``, as TFRecords."""

    def __init__(self, log_dir: str):
        from tensorboard.compat.proto.event_pb2 import Event
        from tensorboard.compat.proto.summary_pb2 import Summary
        from tensorboard.summary.writer.record_writer import RecordWriter

        self._event, self._summary = Event, Summary
        name = (f"events.out.tfevents.{int(time.time()):010d}."
                f"{socket.gethostname()}.{os.getpid()}.0")
        self._rec = RecordWriter(open(os.path.join(log_dir, name), "wb"))
        self._write(Event(wall_time=time.time(), file_version="brain.Event:2"))

    def _write(self, event) -> None:
        self._rec.write(event.SerializeToString())

    def add_scalar(self, tag: str, value: float, step: int,
                   walltime: float) -> None:
        self._write(self._event(
            wall_time=walltime, step=step,
            summary=self._summary(value=[self._summary.Value(
                tag=tag, simple_value=value)])))

    def flush(self) -> None:
        self._rec.flush()

    def close(self) -> None:
        self._rec.close()


class MetricsWriter:
    def __init__(self, log_dir: str, enable_tensorboard: bool = True,
                 role: Optional[str] = None, run_id: Optional[str] = None):
        self.log_dir = log_dir
        self.role = role
        self.run_id = run_id
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a",
                           buffering=1)
        self._tb = None
        if enable_tensorboard:
            try:
                self._tb = _EventFile(log_dir)
            except Exception:  # noqa: BLE001 - the mirror is best effort
                self._tb = None

    @property
    def tensorboard(self) -> bool:
        """Whether the TensorBoard mirror is on."""
        return self._tb is not None

    def _write(self, rec: dict) -> None:
        # setdefault: a row that carries its own attribution keeps it
        if self.role is not None:
            rec.setdefault("role", self.role)
        if self.run_id is not None:
            rec.setdefault("run_id", self.run_id)
        self._jsonl.write(json.dumps(rec) + "\n")

    def scalar(self, tag: str, value: float, step: int,
               wall: Optional[float] = None) -> None:
        rec = {"tag": tag, "value": float(value), "step": int(step),
               "wall": wall if wall is not None else time.time()}
        self._write(rec)
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step),
                                walltime=rec["wall"])

    def scalars(self, kv: dict, step: int,
                wall: Optional[float] = None) -> None:
        if wall is None:
            wall = time.time()
        for tag, value in kv.items():
            self.scalar(tag, value, step, wall)

    def histogram(self, tag: str, values: Sequence[float], step: int,
                  wall: Optional[float] = None,
                  count: Optional[int] = None) -> None:
        """One summarized-distribution row; ``count`` overrides the event
        count when ``values`` is a bounded reservoir of more events."""
        if not len(values):
            return
        s = summarize_histogram(values)
        rec = {"tag": tag, "kind": "histogram", "step": int(step),
               "wall": wall if wall is not None else time.time()}
        rec.update(s)
        if count is not None:
            rec["count"] = int(count)
        self._write(rec)
        if self._tb is not None:
            for k in ("p50", "p95", "max"):
                self._tb.add_scalar(f"{tag}/{k}", float(s[k]), int(step),
                                    walltime=rec["wall"])

    def bucket_histogram(self, tag: str, counts, *, log10_lo: float,
                         log10_hi: float, step: int,
                         wall: Optional[float] = None,
                         extra: Optional[dict] = None) -> None:
        """One pre-bucketed distribution row over the fixed log10 grid
        [log10_lo, log10_hi); ``extra`` scalars ride the same row."""
        rec = {"tag": tag, "kind": "buckets", "step": int(step),
               "wall": wall if wall is not None else time.time(),
               "counts": [int(c) for c in counts],
               "log10_lo": float(log10_lo), "log10_hi": float(log10_hi)}
        if extra:
            rec.update({k: (float(v) if isinstance(v, (int, float))
                            else v) for k, v in extra.items()})
        self._write(rec)

    def span(self, span: str, role: str, trace_id: str, dur_ms: float,
             step: int = 0, wall: Optional[float] = None) -> None:
        """One sampled trace event (utils/tracing.py), JSONL only."""
        self._write({"tag": f"trace/{role}/{span}", "kind": "span",
                     "span": span, "role": role, "trace_id": trace_id,
                     "value": float(dur_ms), "step": int(step),
                     "wall": wall if wall is not None else time.time()})

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class ScalarsTail:
    """Incremental reader of a run dir's ``scalars.jsonl``: ``poll()``
    returns the rows appended since the previous poll, from the byte
    offset after the last whole line, so a poll costs the new rows, not
    the run's.  A trailing line without its newline is left for the next
    poll (the writer may be mid-append); a terminated line that does not
    decode (torn by a kill) is skipped for good; a file that shrank
    (rotated, or a new run in the same dir) is read from the start.
    ``max_bytes`` bounds one poll's read: a reader far behind catches up
    over several polls, and a single line longer than the bound is
    dropped rather than read forever."""

    def __init__(self, log_dir: str, max_bytes: Optional[int] = None):
        self.path = os.path.join(log_dir, "scalars.jsonl")
        self._offset = 0
        self._max_bytes = max_bytes

    def poll(self) -> List[dict]:
        try:
            with open(self.path, "rb") as f:
                f.seek(0, os.SEEK_END)
                if f.tell() < self._offset:
                    self._offset = 0  # truncated or rotated
                f.seek(self._offset)
                data = (f.read() if self._max_bytes is None
                        else f.read(self._max_bytes))
        except OSError:
            return []
        end = data.rfind(b"\n")
        if end < 0:
            if self._max_bytes is not None and len(data) >= self._max_bytes:
                self._offset += len(data)  # one line wider than the bound
            return []
        self._offset += end + 1
        out = []
        for line in data[:end + 1].splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line.decode()))
            except (ValueError, UnicodeDecodeError):
                continue
        return out


def is_scalar_row(rec: dict) -> bool:
    """A plain scalar row: a ``tag``, a numeric ``value`` and no
    distribution ``kind``."""
    return (isinstance(rec, dict) and "tag" in rec
            and isinstance(rec.get("value"), (int, float))
            and rec.get("kind") in (None, "scalar"))


def read_rows(log_dir: str) -> List[dict]:
    """Every row of a run dir's ``scalars.jsonl``, of every kind; a line
    torn by a kill mid-write is skipped."""
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


def read_scalars(log_dir: str) -> List[dict]:
    """The scalar rows of a run dir's ``scalars.jsonl`` (histogram,
    bucket and span rows left out: ``read_rows`` has them)."""
    return [r for r in read_rows(log_dir) if is_scalar_row(r)]


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
