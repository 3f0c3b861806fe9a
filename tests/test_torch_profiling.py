"""The port's profiler window (pytorch_distributed_tpu_torch/utils/
profiling.py ``sanitize_label`` and ``trace``, utils/perf.py
``run_profile_window``) against the JAX package's on the CPU:
``sanitize_label`` exactly; the window on, off, nested and from a thread
other than the one doing the work, writing a Chrome trace; and
``StepTimer``'s rows exactly."""

import json
import os
import threading
import time

import pytest
import torch

from pytorch_distributed_tpu.utils import profiling as jprof
from pytorch_distributed_tpu_torch.utils import perf, profiling

LABELS = ["live", "../../etc/passwd", "a b/c\\d", "...", "", "tprofile-1.x",
          "ünïcode", ".hidden", "-dash", "a" * 40, 17]


@pytest.mark.parametrize("label", LABELS)
def test_sanitize_label_matches_the_reference(label):
    assert profiling.sanitize_label(label) == jprof.sanitize_label(label)


@pytest.fixture(autouse=True)
def _no_profile_env(monkeypatch):
    monkeypatch.delenv("TPU_APEX_PROFILE", raising=False)


def _trace_events(path: str) -> list:
    (name,) = os.listdir(path)
    assert name.endswith(".pt.trace.json")
    with open(os.path.join(path, name)) as f:
        return json.load(f)["traceEvents"]


def test_disabled_trace_yields_none():
    with profiling.trace("x") as path:
        assert path is None


def test_trace_writes_a_chrome_trace_under_the_sanitized_label(tmp_path):
    with profiling.trace("../evil label", log_dir=str(tmp_path)) as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert path == os.path.join(str(tmp_path), "evil-label")
    names = {e.get("name") for e in _trace_events(path)}
    assert "aten::mm" in names


def test_profile_env_enables_the_window(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_APEX_PROFILE", str(tmp_path))
    with profiling.trace("env") as path:
        torch.ones(8).sum()
    assert path == os.path.join(str(tmp_path), "env")
    assert _trace_events(path)


def test_nested_capture_warns_and_records_nothing(tmp_path):
    with profiling.trace("outer", log_dir=str(tmp_path)) as outer:
        with pytest.warns(UserWarning, match="already active"):
            with profiling.trace("inner", log_dir=str(tmp_path)) as inner:
                assert inner is None
        torch.ones(8).sum()
    assert outer is not None and _trace_events(outer)
    assert not os.path.exists(os.path.join(str(tmp_path), "inner"))
    with profiling.trace("after", log_dir=str(tmp_path)) as again:
        assert again is not None  # the lock was released


def test_a_thread_cannot_be_the_first_to_trace(tmp_path, monkeypatch):
    """Before the profiler is initialised on the main thread, a window
    from another thread is refused with the reason (on a card, the first
    trace begun off the main thread hangs)."""
    monkeypatch.setattr(profiling, "_initialized", False)
    replies: list = []
    t = threading.Thread(target=lambda: replies.append(
        perf.run_profile_window(str(tmp_path), "early", seconds=0.05)))
    t.start()
    t.join(30)
    (reply,) = replies
    assert "init_profiler() on the main thread" in reply["error"]
    assert not perf._profile_lock.locked()
    profiling.init_profiler()
    assert profiling._initialized


def test_profile_window_from_another_thread(tmp_path):
    """A serve thread opens the window while this thread keeps working;
    the window is bounded and one at a time."""
    profiling.init_profiler()  # on this, the main thread
    stop = threading.Event()
    replies: list = []

    def serve():
        replies.append(perf.run_profile_window(str(tmp_path), "live",
                                               seconds=0.2))
        stop.set()

    t = threading.Thread(target=serve)
    t.start()
    x = torch.ones(32, 32)
    deadline = time.monotonic() + 60
    while not stop.is_set() and time.monotonic() < deadline:
        x = (x @ x).clamp(max=1.0)
    t.join(30)
    assert not t.is_alive()
    (reply,) = replies
    assert reply == {"trace_dir": os.path.join(str(tmp_path), "live"),
                     "seconds": 0.2}
    assert _trace_events(reply["trace_dir"])


def _ask_in_thread(tmp_path, label: str, seconds: float = 0.05):
    replies: list = []
    t = threading.Thread(target=lambda: replies.append(
        perf.run_profile_window(str(tmp_path), label, seconds=seconds)))
    t.start()
    return t, replies


def test_the_holder_opens_and_closes_other_threads_windows(tmp_path,
                                                           monkeypatch):
    """This thread holds the windows (as the learner's loop does): a
    window asked for from another thread is opened and closed here, at
    ``poll_window`` between two units of work, and written by the asker."""
    opened_on = []
    real_open = profiling._open
    monkeypatch.setattr(profiling, "_open", lambda: (
        opened_on.append(threading.get_ident()), real_open())[1])
    profiling.hold_windows()
    try:
        t, replies = _ask_in_thread(tmp_path, "held")
        x = torch.ones(32, 32)
        deadline = time.monotonic() + 60
        while t.is_alive() and time.monotonic() < deadline:
            x = (x @ x).clamp(max=1.0)  # a dispatch
            profiling.poll_window()
        t.join(30)
    finally:
        profiling.release_windows()
    (reply,) = replies
    assert reply["trace_dir"] == os.path.join(str(tmp_path), "held")
    assert _trace_events(reply["trace_dir"])
    # each slice of the window (utils/profiling.py) opens on the holder
    assert opened_on and set(opened_on) == {threading.get_ident()}
    assert profiling._request is None and profiling._host is None


@pytest.mark.parametrize("held", [True, False], ids=["holder", "asker"])
def test_a_window_is_recorded_in_slices_joined_in_one_trace(
        tmp_path, monkeypatch, held):
    """A window is cut into slices, each stopped on the thread that opened
    it (the holder at its polls, or the asking thread while it waits), and
    the slices' events are joined in the one Chrome trace."""
    profiling.init_profiler()
    monkeypatch.setattr(profiling, "SLICE_FIRST_S", 0.02)
    monkeypatch.setattr(profiling, "SLICE_MIN_S", 0.02)
    monkeypatch.setattr(profiling, "SLICE_MAX_S", 0.05)
    stopped_on = []
    real_stop = profiling._stop
    monkeypatch.setattr(profiling, "_stop", lambda prof: (
        stopped_on.append(threading.get_ident()), real_stop(prof))[1])
    if held:
        profiling.hold_windows()
    try:
        t, replies = _ask_in_thread(tmp_path, "sliced", seconds=0.3)
        x = torch.ones(32, 32)
        deadline = time.monotonic() + 60
        while t.is_alive() and time.monotonic() < deadline:
            x = (x @ x).clamp(max=1.0)
            profiling.poll_window()
        t.join(30)
    finally:
        profiling.release_windows()
    (reply,) = replies
    assert reply["seconds"] == 0.3
    assert len(stopped_on) >= 2
    assert len(set(stopped_on)) == 1
    assert (stopped_on[0] == threading.get_ident()) == held
    events = _trace_events(reply["trace_dir"])
    if held:  # the asker only sleeps: the holder's matmuls are recorded
        assert sum(e.get("name") == "aten::mm" for e in events) > 4


def test_a_holder_that_ends_refuses_the_window(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "HOST_WAIT_S", 30.0)
    profiling.hold_windows()
    t, replies = _ask_in_thread(tmp_path, "late")
    deadline = time.monotonic() + 30
    while profiling._request is None and time.monotonic() < deadline:
        time.sleep(0.01)
    profiling.release_windows()  # the loop ends before it polls
    t.join(30)
    (reply,) = replies
    assert "ended, or the asker gave up" in reply["error"]
    assert not os.listdir(os.path.join(str(tmp_path), "late"))


def test_an_asker_that_gives_up_leaves_no_window_open(tmp_path,
                                                      monkeypatch):
    """The holder does not poll within ``HOST_WAIT_S``: the asker gets
    the reason, and the holder's next poll drops the request instead of
    opening a profiler no one closes."""
    monkeypatch.setattr(profiling, "HOST_WAIT_S", 0.2)
    opened = []
    monkeypatch.setattr(profiling, "_open", lambda: opened.append(1))
    profiling.hold_windows()
    try:
        t, replies = _ask_in_thread(tmp_path, "slow")
        t.join(30)
        (reply,) = replies
        assert "not opened within 0.2 s" in reply["error"]
        profiling.poll_window()
        assert opened == [] and profiling._request is None
    finally:
        profiling.release_windows()


def test_profile_window_clamps_and_refuses(tmp_path):
    assert "bad seconds" in perf.run_profile_window(str(tmp_path),
                                                    seconds="soon")["error"]
    reply = perf.run_profile_window(str(tmp_path), "short", seconds=0.0)
    assert reply["seconds"] == 0.05
    with profiling.trace("held", log_dir=str(tmp_path)), \
            pytest.warns(UserWarning, match="already active"):
        reply = perf.run_profile_window(str(tmp_path), "busy",
                                        seconds=0.05)
    assert "already active" in reply["error"]
    perf._profile_lock.acquire()
    try:
        reply = perf.run_profile_window(str(tmp_path), "busy")
    finally:
        perf._profile_lock.release()
    assert reply == {"error": "a profile window is already active"}


def test_profile_window_max_knob_bounds_the_window(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_APEX_PERF_PROFILE_WINDOW_MAX", "0.1")
    assert perf.run_profile_window(str(tmp_path), "knob",
                                   seconds=5.0)["seconds"] == 0.1
    # an explicit bound is the caller's, as the reference's fleet passes it
    assert perf.run_profile_window(str(tmp_path), "explicit", seconds=5.0,
                                   max_seconds=0.06)["seconds"] == 0.06


def test_step_timer_matches_the_reference():
    got, want = profiling.StepTimer("actor"), jprof.StepTimer("actor")
    for t in (got, want):
        for name, s in (("act", 0.010), ("act", 0.030), ("env", 0.005)):
            t.add(name, s)
    a, b = got.drain(), want.drain()
    wall = [k for k in a if k.endswith("_last_wall")]
    assert {k: v for k, v in a.items() if k not in wall} == {
        k: v for k, v in b.items() if k not in wall}
    assert sorted(a) == sorted(b) and got.drain() == {}
