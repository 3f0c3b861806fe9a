"""The port's ``MetricsWriter`` (utils/metrics.py) against the JAX
package's, on the CPU:

- row for row, the same calls (walls passed in) write the same JSON:
  scalar, scalars, histogram (with a reservoir ``count``), buckets (with
  extra scalars) and span rows, with ``role`` and ``run_id``;
- ``summarize_histogram`` and ``is_scalar_row`` are the reference's;
- the TensorBoard mirror's event files hold ``<tag>/p50|p95|max`` for a
  histogram and the scalar tags, and buckets and spans stay out;
- ``read_scalars`` and ``timer_phases`` read scalar rows only
  (``read_rows`` has every row), and the logger writes its event files
  under ``visualize``."""

import glob
import json
import os
import tempfile

import numpy as np
import pytest

from pytorch_distributed_tpu.utils import metrics as jmetrics
from pytorch_distributed_tpu_torch.utils import metrics


def _calls(w):
    rng = np.random.default_rng(0)
    w.scalar("learner/critic_loss", 0.25, 10, wall=1000.0)
    w.scalars({"a/x": 1, "a/y": 2.5}, step=11, wall=1001.0)
    w.histogram("learner/staleness", rng.integers(0, 9, 50).tolist(), 12,
                wall=1002.0)
    w.histogram("trace/actor/enqueue_ms", rng.random(7).tolist(), 12,
                wall=1003.0, count=4100)
    w.histogram("empty", [], 12, wall=1004.0)  # writes nothing
    w.bucket_histogram("replay/priority", [0, 3, 5, 0], log10_lo=-6.0,
                       log10_hi=3.0, step=13, wall=1005.0,
                       extra={"ess": 4.5, "rows": 8, "mass": 2.0,
                              "note": "x"})
    w.span("learn", role="learner", trace_id="00ab", dur_ms=1.2345,
           step=14, wall=1006.0)


def _rows(path):
    return [json.loads(line) for line in open(path)]


def test_rows_are_the_reference_rows():
    d = tempfile.mkdtemp(prefix="rows_")
    w = metrics.MetricsWriter(f"{d}/port", enable_tensorboard=False,
                              role="learner", run_id="r1")
    jw = jmetrics.MetricsWriter(f"{d}/ref", enable_tensorboard=False,
                                role="learner", run_id="r1")
    _calls(w)
    _calls(jw)
    w.close()
    jw.close()
    got = _rows(f"{d}/port/scalars.jsonl")
    want = _rows(f"{d}/ref/scalars.jsonl")
    assert got == want and len(got) == 7
    assert [r.get("kind") for r in got] == [
        None, None, None, "histogram", "histogram", "buckets", "span"]
    assert not os.path.exists(f"{d}/port/events") and not glob.glob(
        f"{d}/port/events.out.tfevents.*")


@pytest.mark.parametrize("values", [[3.0], [5, 1, 4, 1, 5, 9, 2, 6],
                                    list(range(100))])
def test_summaries_are_the_reference(values):
    assert metrics.summarize_histogram(values) == \
        jmetrics.summarize_histogram(values)
    for r in ({"tag": "a", "value": 1.0}, {"tag": "a", "value": "x"},
              {"tag": "a", "kind": "span", "value": 1.0},
              {"tag": "a", "kind": "scalar", "value": 2},
              {"value": 1.0}, [1]):
        assert metrics.is_scalar_row(r) == jmetrics.is_scalar_row(r)
    with pytest.raises(ValueError):
        metrics.summarize_histogram([])


def _records(log_dir):
    """The scalar (tag, step, value) records of the event files, read as
    TFRecords with their checksums (TensorBoard's own reader imports
    TensorFlow where it is installed: seconds of a test worker's CPU)."""
    import struct

    from tensorboard.compat.proto.event_pb2 import Event
    from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import (
        masked_crc32c,
    )

    out = []
    for path in glob.glob(f"{log_dir}/events.out.tfevents.*"):
        data = open(path, "rb").read()
        i = 0
        while i < len(data):
            (n,) = struct.unpack_from("<Q", data, i)
            assert struct.unpack_from("<I", data, i + 8)[0] == masked_crc32c(
                data[i:i + 8])
            body = data[i + 12:i + 12 + n]
            assert struct.unpack_from("<I", data, i + 12 + n)[0] == \
                masked_crc32c(body)
            ev = Event.FromString(body)
            out += [(v.tag, ev.step, v.simple_value) for v in ev.summary.value]
            i += 16 + n
    return out


def test_tensorboard_mirror_holds_the_percentiles():
    d = tempfile.mkdtemp(prefix="tb_")
    w = metrics.MetricsWriter(d, enable_tensorboard=True, role="logger")
    assert w.tensorboard
    _calls(w)
    w.close()
    assert glob.glob(f"{d}/events.out.tfevents.*")
    recs = _records(d)
    tags = {t for t, _step, _v in recs}
    assert {"learner/staleness/p50", "learner/staleness/p95",
            "learner/staleness/max", "learner/critic_loss",
            "a/x"} <= tags
    assert not any(t.startswith(("replay/priority", "trace/learner"))
                   for t in tags)
    assert ("learner/critic_loss", 10, 0.25) in recs
    p95 = [v for t, step, v in recs if t == "learner/staleness/p95"]
    assert len(p95) == 1


def test_readers_skip_distribution_rows():
    d = tempfile.mkdtemp(prefix="read_")
    w = metrics.MetricsWriter(d, enable_tensorboard=False, role="actor-0")
    w.scalars({"actor/time_env_total_ms": 30.0, "actor/time_env_calls": 10,
               "actor/time_act_total_ms": 20.0, "actor/time_act_calls": 10,
               "actor/time_advance_total_ms": 5.0,
               "actor/time_advance_calls": 10}, step=1)
    # distribution rows under the timer's own tags: no value, or a
    # value that is not the timer's
    w.histogram("actor/time_env_total_ms", [1.0, 2.0], step=2)
    w.bucket_histogram("actor/time_env_calls", [1, 2], log10_lo=0,
                       log10_hi=1, step=2)
    w.span("env", role="actor", trace_id="01", dur_ms=99.0, step=2)
    w.close()
    assert len(metrics.read_rows(d)) == 9
    scalars = metrics.read_scalars(d)
    assert len(scalars) == 6 and all(metrics.is_scalar_row(r)
                                     for r in scalars)
    phases = metrics.timer_phases(d)
    assert phases["env"] == 3.0 and phases["act"] == 2.0
    assert phases["tick"] == 5.5 and phases["ticks"] == 10


def test_logger_mirrors_under_visualize():
    from pytorch_distributed_tpu_torch.agents.clocks import (
        ActorStats, EvaluatorStats, GlobalClock, LearnerStats,
    )
    from pytorch_distributed_tpu_torch.agents.logger import run_logger
    from pytorch_distributed_tpu_torch.config import build_options

    for visualize in (True, False):
        opt = build_options(12, device="cpu", steps=1, visualize=visualize,
                            root_dir=tempfile.mkdtemp(prefix="logger_"),
                            refs="r", logger_freq=0)
        clock = GlobalClock()
        clock.set_learner_step(1)
        learner = LearnerStats()
        learner.add(counter=1, critic_loss=0.5, q_mean=1.0, grad_norm=2.0,
                    steps_per_sec=3.0)
        ev = EvaluatorStats()
        ev.done.value = 1
        run_logger(opt, clock, ActorStats(), learner, ev)
        has_events = bool(glob.glob(f"{opt.log_dir}/events.out.tfevents.*"))
        assert has_events == visualize
        if visualize:
            assert ("learner/critic_loss", 1, 0.5) in _records(opt.log_dir)
