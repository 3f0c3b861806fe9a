"""The port's flight recorder (pytorch_distributed_tpu_torch/utils/
flight_recorder.py) against the JAX package's, on the same event streams:
the ring's bound, the dump's format (a header line, then the newest
events, line for line the reference's but for the wall clock and the
pid), ``dump_all`` over the registry, the run id from ``configure`` and
from the inherited environment, an unconfigured process that writes
nothing, and a SIGKILL drill whose injector dumps before the signal.
Mirrors the reference's tests/test_observability.py:270-323."""

import json
import os
import signal
import subprocess
import sys

import pytest

from pytorch_distributed_tpu.utils import flight_recorder as jax_fr
from pytorch_distributed_tpu_torch.utils import flight_recorder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the fields a dump line carries that differ run to run
VOLATILE = ("t", "pid")


@pytest.fixture(autouse=True)
def _isolate():
    """Empty registries and no inherited blackbox dir or run id, before
    and after each test (``configure(export_env=True)`` writes both)."""
    saved = {v: os.environ.pop(v, None)
             for v in ("TPU_APEX_BLACKBOX_DIR", "TPU_APEX_RUN_ID")}
    for mod in (jax_fr, flight_recorder):
        mod.reset()
    yield
    for mod in (jax_fr, flight_recorder):
        mod.reset()
    for var, val in saved.items():
        os.environ.pop(var, None)
        if val is not None:
            os.environ[var] = val


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _stable(lines):
    return [{k: v for k, v in ln.items() if k not in VOLATILE}
            for ln in lines]


@pytest.mark.parametrize("capacity,events", [(16, 100), (64, 10), (1, 3)])
def test_ring_bound_and_dump_match_the_reference(tmp_path, capacity, events):
    got = {}
    for name, mod in (("jax", jax_fr), ("port", flight_recorder)):
        rec = mod.FlightRecorder("actor-3", capacity=capacity)
        for i in range(events):
            rec.record("tick", i=i, tag=f"t{i % 3}")
        path = rec.dump(log_dir=str(tmp_path / name), reason="unit")
        assert path.endswith(os.path.join("blackbox", "actor-3.jsonl"))
        got[name] = _lines(path)
    assert _stable(got["port"]) == _stable(got["jax"])
    header, body = got["port"][0], got["port"][1:]
    assert header["kind"] == "dump" and header["reason"] == "unit"
    assert header["recorded_total"] == events
    assert header["events"] == len(body) == min(capacity, events)
    assert [e["i"] for e in body] == list(range(events - len(body), events))


def test_a_later_dump_replaces_the_earlier(tmp_path):
    rec = flight_recorder.FlightRecorder("learner", capacity=8)
    rec.record("anomaly", step=1)
    rec.dump(log_dir=str(tmp_path), reason="first")
    rec.record("rollback", epoch=0)
    path = rec.dump(log_dir=str(tmp_path), reason="second")
    lines = _lines(path)
    assert lines[0]["reason"] == "second"
    assert [e["kind"] for e in lines[1:]] == ["anomaly", "rollback"]


def test_dump_all_and_run_id_match_the_reference(tmp_path):
    got = {}
    for name, mod in (("jax", jax_fr), ("port", flight_recorder)):
        mod.configure(str(tmp_path / name), run_id="run-7")
        assert mod.run_id() == "run-7"
        for role in ("runtime", "learner", "actor/1"):
            mod.get_recorder(role).record("hello", role=role)
        assert mod.get_recorder("runtime") is mod.get_recorder("runtime")
        paths = sorted(mod.dump_all("drill"))
        got[name] = ([os.path.relpath(p, str(tmp_path / name))
                      for p in paths],
                     [_stable(_lines(p)) for p in paths])
    assert got["port"] == got["jax"]
    assert got["port"][0] == [os.path.join("blackbox", f) for f in (
        "actor_1.jsonl", "learner.jsonl", "runtime.jsonl")]
    assert all(ln[0]["run_id"] == "run-7" for ln in got["port"][1])


def test_configure_exports_to_children_and_reset_forgets(tmp_path):
    flight_recorder.configure(str(tmp_path), export_env=True, run_id="r1")
    assert os.environ["TPU_APEX_BLACKBOX_DIR"] == str(tmp_path)
    assert os.environ["TPU_APEX_RUN_ID"] == "r1"
    code = ("from pytorch_distributed_tpu_torch.utils import "
            "flight_recorder as fr\n"
            "fr.get_recorder('actor-0').record('tick')\n"
            "print(fr.run_id(), fr.dump_all('child')[0])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert out == ["r1", str(tmp_path / "blackbox" / "actor-0.jsonl")]
    flight_recorder.reset()
    for var in ("TPU_APEX_BLACKBOX_DIR", "TPU_APEX_RUN_ID"):
        del os.environ[var]
    assert flight_recorder.run_id() is None
    assert flight_recorder.dump_all("gone") == []


def test_unconfigured_process_never_writes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for mod in (jax_fr, flight_recorder):
        rec = mod.get_recorder("quiet")
        rec.record("tick")
        assert rec.dump(reason="no dir") is None
        assert mod.dump_all("no dir") == []
    assert os.listdir(tmp_path) == []


_KILL_CHILD = """
import sys
from pytorch_distributed_tpu_torch.utils import flight_recorder
from pytorch_distributed_tpu_torch.utils.faults import FaultInjector, \\
    parse_faults

flight_recorder.configure(sys.argv[1])
recorder = flight_recorder.get_recorder("actor-0", capacity=64)
injector = FaultInjector(parse_faults(sys.argv[2]), name="blackbox-drill")
for i in range(10_000):
    recorder.record("tick", i=i)
    injector.frame()
print("DONE", flush=True)
"""


def test_dump_before_a_sigkill_drill(tmp_path):
    """The injector dumps every ring before its SIGKILL, the only code
    that can run before the signal: the post-mortem holds the ticks up to
    the kill and the fault itself."""
    proc = subprocess.run(
        [sys.executable, "-c", _KILL_CHILD, str(tmp_path), "kill@37"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL
    assert "DONE" not in proc.stdout
    lines = _lines(tmp_path / "blackbox" / "actor-0.jsonl")
    assert lines[0]["kind"] == "dump" and "kill" in lines[0]["reason"]
    ticks = [e["i"] for e in lines if e["kind"] == "tick"]
    assert ticks[-1] == 37 and len(ticks) == 38
    faults = _lines(tmp_path / "blackbox" / "faults-blackbox-drill.jsonl")
    assert [(e["action"], e["frame"]) for e in faults[1:]] == [("kill", 37)]
