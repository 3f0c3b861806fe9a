"""The port's tracing plane (utils/tracing.py) against the JAX package's,
on the CPU:

- a ``TracedChunk`` keeps its trace id and birth wall through a spawn
  queue's pickle, and stays a list of its rows;
- ``Tracer.flush_to`` writes the reference's rows for the same recorded
  events (walls passed in; the histogram rows' own walls aside);
- ``TPU_APEX_TRACE=0`` ships plain lists and records nothing;
- a chunk's trace id reaches the learner's ``learn`` span: config 12
  through ``main`` on the thread backend, where the actor's ``enqueue``
  span and the learner's ``learn`` span share an id in
  ``scalars.jsonl``."""

import json
import multiprocessing as mp
import queue
import tempfile

import numpy as np
import pytest

from pytorch_distributed_tpu.utils import tracing as jtracing
from pytorch_distributed_tpu.utils.metrics import (
    MetricsWriter as JaxMetricsWriter,
)
from pytorch_distributed_tpu_torch import main as port_main
from pytorch_distributed_tpu_torch.memory.feeder import QueueFeeder
from pytorch_distributed_tpu_torch.utils import metrics, tracing
from pytorch_distributed_tpu_torch.utils.experience import Transition


@pytest.fixture(autouse=True)
def _fresh_tracers():
    tracing.reset()
    yield
    tracing.reset()


def _row(i: int) -> Transition:
    return Transition(np.full((2, 3), i, np.uint8), np.int32(i),
                      np.float32(i), np.float32(0.9),
                      np.zeros((2, 3), np.uint8), np.float32(0))


def test_traced_chunk_survives_a_spawn_queue():
    q = mp.get_context("spawn").Queue()
    chunk = tracing.TracedChunk([_row(i) for i in range(4)], born=123.25)
    q.put(chunk)
    got = q.get(timeout=30)
    q.close()
    assert type(got) is tracing.TracedChunk
    assert got.trace_id == chunk.trace_id != 0
    assert got.born == 123.25
    assert [int(t.action) for t in got] == [0, 1, 2, 3]
    # the reference's chunk pickles to the same triple
    ref = jtracing.TracedChunk(list(chunk), chunk.trace_id, chunk.born)
    assert ref.__reduce__()[1][1:] == chunk.__reduce__()[1][1:]


def _events():
    rng = np.random.default_rng(0)
    return [("enqueue" if i % 3 else "learn", float(rng.random() * 5),
             int(rng.integers(1, 2 ** 62)) if i % 4 else 0, 1000.0 + i)
            for i in range(40)]


def _strip(rows):
    return [{k: v for k, v in r.items()
             if not (r.get("kind") == "histogram" and k == "wall")}
            for r in rows]


def test_flush_to_writes_the_reference_rows():
    d = tempfile.mkdtemp(prefix="trace_rows_")
    port_dir, ref_dir = f"{d}/port", f"{d}/ref"
    tr = tracing.Tracer("actor", enabled=True, sample=0.5)
    jtr = jtracing.Tracer("actor", enabled=True, sample=0.5)
    for span, dur, tid, wall in _events():
        tr.record(span, dur, trace_id=tid, wall=wall)
        jtr.record(span, dur, trace_id=tid, wall=wall)
    w = metrics.MetricsWriter(port_dir, enable_tensorboard=False,
                              role="actor-0", run_id="r")
    jw = JaxMetricsWriter(ref_dir, enable_tensorboard=False,
                          role="actor-0", run_id="r")
    tr.flush_to(w, step=7)
    jtr.flush_to(jw, step=7)
    w.close()
    jw.close()
    got = metrics.read_rows(port_dir)
    want = [json.loads(line) for line in open(f"{ref_dir}/scalars.jsonl")]
    assert len(got) == len(want) > 10
    assert _strip(got) == _strip(want)
    kinds = {r["kind"] for r in got}
    assert kinds == {"histogram", "span"}
    assert tracing.current_trace() == jtracing.current_trace() != 0


def test_trace_off_ships_plain_lists(monkeypatch):
    monkeypatch.setenv("TPU_APEX_TRACE", "0")
    assert not tracing.active()
    q = queue.Queue()
    f = QueueFeeder(q, chunk=3)
    tr = tracing.Tracer("actor")
    f.set_tracer(tr)
    for i in range(3):
        f.feed(_row(i))
    chunk = q.get_nowait()
    assert type(chunk) is list and len(chunk) == 3
    tr.record("enqueue", 1.0, trace_id=5)
    assert tr.drain() == ({}, [], {})
    monkeypatch.setenv("TPU_APEX_TRACE", "1")
    for i in range(3):
        f.feed(_row(i))
    assert type(q.get_nowait()) is tracing.TracedChunk


def test_a_chunk_trace_reaches_the_learn_span():
    root = tempfile.mkdtemp(prefix="trace_run_")
    port_main.main([
        "--config", "12", "--backend", "thread", "--device", "cpu",
        "--memory-size", "2048", "--batch-size", "8", "--steps", "40",
        "--num-actors", "1", "--num-envs-per-actor", "2",
        "--no-tensorboard", "--set", "learn_start=64",
        "--set", "learner_freq=10", "--set", "actor_freq=32",
        "--set", "evaluator_nepisodes=0", "--set", f"root_dir={root}",
        "--set", "refs=t"])
    rows = metrics.read_rows(f"{root}/logs/t")
    spans = [r for r in rows if r.get("kind") == "span"]
    ids = {(r["role"], r["span"]): set() for r in spans}
    for r in spans:
        ids[(r["role"], r["span"])].add(r["trace_id"])
    enq = ids.get(("actor", "enqueue"), set())
    learn = ids.get(("learner", "learn"), set())
    assert enq and learn and enq & learn, sorted(ids)
    assert ("feeder", "feed") in ids
    hist = {r["tag"] for r in rows if r.get("kind") == "histogram"}
    assert {"trace/actor/enqueue_ms", "trace/learner/learn_ms",
            "trace/feeder/feed_ms"} <= hist
    # the span rows never reach the scalar readers
    assert all(r.get("kind") is None for r in metrics.read_scalars(
        f"{root}/logs/t"))
