"""Per-phase wall-time accounting and the profiler's trace window — the
port of pytorch_distributed_tpu/utils/profiling.py: ``StepTimer``
(:33-100), ``sanitize_label`` (:96-105) and ``trace`` (:108-154).

A worker wraps its hot loop's phases (the actors: ``act``, ``dispatch``,
``sync``, ``env``, ``advance``, ``param_swap``) and drains the timer on its
stats cadence into ``scalars.jsonl``, under the reference's tags:
``{prefix}/time_{phase}_ms`` (the window's mean), ``_max_ms``, ``_calls``,
``_total_ms`` and ``_last_wall`` (the wall clock of the phase's last
occurrence).

``trace(label, log_dir)`` captures a ``torch.profiler`` trace of the block
it wraps, where the reference captures an XLA trace.  It is on when
``log_dir`` is given or ``TPU_APEX_PROFILE`` names a directory, and yields
``{dir}/{sanitize_label(label)}``, or None when it is off or another trace
of this process is open (a nested capture warns and records nothing; the
outer window goes on).  On a machine with a CUDA device it records CUDA
activity alone: CUPTI sees every kernel and copy of the process, whatever
thread launched them, and no host op is recorded on any thread.  Without
one it records the host's ops.  The trace is written on exit as
``{host}.{pid}.pt.trace.json`` in that directory, a Chrome trace that
``chrome://tracing`` and TensorBoard's profile plugin open.

A window is recorded in slices.  Kineto's stop and its Chrome-trace
writer are each one C++ call that holds the GIL for the whole of it, in
proportion to the events (torch 2.11 beside an NVIDIA H100 80GB HBM3,
700.00 W, ``chip_smoke.py fleet_planes``: a 0.5 s window of 140,600
kernels in one piece, its stop held the GIL 1.73 s and another thread
of the process waited 2.79 s; in slices, 0.20 s and 0.30 s).  In one
piece a window starves every other thread of its process for seconds, a
learner host's gateway with it, and its standby or its replica registry
takes it for dead.  So the window's profiler is stopped
and started again once a slice is ``slice_s`` long, each slice is
written by Kineto on its own, and the slices' events are joined into
the one file in Python, a few events at a time.  A slice's stop sets the
next slice's length so that a stop holds the GIL about ``SLICE_HOLD_S``.
The kernels that run while a slice is cut are not recorded.  The holder
(below) cuts its windows at its polls, and a window opened on the asking
thread is cut while that thread waits in ``sleep_sliced``.

Where the profiler starts and stops matters on the H100.  Its first trace
in a process initialises Kineto's client, which only the thread that
imported torch may do: begun on another thread it prints "External init
callback must run in same thread as registerClient" and hung.  And a
profiler started and stopped on one thread while another launched CUDA
graph replays hung in ``stop_trace`` with CPU and CUDA activity, and
with CUDA activity alone hung in one run and not in another.  So a loop that launches the card's work (the learner, the Anakin loop)
holds the windows (``hold_windows``): a window asked for from any other
thread is opened and closed by that loop's thread at its
``poll_window()`` calls, between two dispatches, while the asking thread
waits (``HOST_WAIT_S`` at most for each) and then writes the trace.  With
no holder the asking thread opens the window itself, after the profiler
was initialised on the main thread (``init_profiler``; ``trace`` on the
main thread does it first); before that it refuses.
"""

from __future__ import annotations

import contextlib
import os
import re
import socket
import threading
import time
import warnings
from typing import Dict, Iterator, Optional


class StepTimer:
    """Wall seconds per named phase; ``drain()`` returns the window's
    per-phase mean, max, count and total, and resets.  The max rides along
    because a mean averages one long stall away."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self._acc: Dict[str, float] = {}
        self._max: Dict[str, float] = {}
        self._n: Dict[str, int] = {}
        self._last_wall: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        """Book a duration timed by the caller (the pipelined actor books
        its dispatch and sync each under their own phase and, summed,
        under ``act``, so the two schedules read alike)."""
        self._acc[name] = self._acc.get(name, 0.0) + seconds
        if seconds > self._max.get(name, 0.0):
            self._max[name] = seconds
        self._n[name] = self._n.get(name, 0) + 1
        self._last_wall[name] = time.time()

    def drain(self) -> Dict[str, float]:
        out = {}
        for name, secs in self._acc.items():
            n = self._n[name]
            out[f"{self.prefix}/time_{name}_ms"] = secs / max(n, 1) * 1e3
            out[f"{self.prefix}/time_{name}_max_ms"] = \
                self._max.get(name, 0.0) * 1e3
            out[f"{self.prefix}/time_{name}_calls"] = float(n)
            out[f"{self.prefix}/time_{name}_total_ms"] = secs * 1e3
            out[f"{self.prefix}/time_{name}_last_wall"] = \
                self._last_wall.get(name, 0.0)
        self._acc.clear()
        self._max.clear()
        self._n.clear()
        self._last_wall.clear()
        return out


def sanitize_label(label: str) -> str:
    """A trace label safe to join into a path: anything outside
    ``[A-Za-z0-9._-]`` becomes ``-``, leading dots and dashes go, and an
    empty result is ``trace``."""
    clean = re.sub(r"[^A-Za-z0-9._-]+", "-", str(label)).lstrip(".-")
    return clean or "trace"


# one trace at a time in a process: the profiler takes no nested window
_trace_lock = threading.Lock()
_trace_active = False
# the profiler was initialised on the main thread
_initialized = False
# the thread that opens and closes other threads' windows, and the window
# it was asked for
HOST_WAIT_S = 60.0
_host_lock = threading.Lock()
_host: Optional[int] = None
_request: Optional["_Window"] = None
# the window the asking thread opened itself (no holder), cut into slices
# while it waits in sleep_sliced
_own_recorder: Optional["_Recorder"] = None


def _activity():
    import torch
    from torch.profiler import ProfilerActivity

    return (ProfilerActivity.CUDA if torch.cuda.is_available()
            else ProfilerActivity.CPU)


def init_profiler() -> None:
    """Initialise the profiler with one empty trace, on the main thread
    (module docstring)."""
    global _initialized
    if _initialized:
        return
    if threading.current_thread() is not threading.main_thread():
        raise RuntimeError("init_profiler runs on the main thread")
    from torch.profiler import profile

    with profile(activities=[_activity()]):
        pass
    _initialized = True


def _open():
    """A started profiler, on the calling thread."""
    from torch.profiler import profile

    if threading.current_thread() is threading.main_thread():
        init_profiler()
    elif not _initialized:
        raise RuntimeError(
            "the profiler is not initialised: call profiling.init_profiler() "
            "on the main thread before a window opens on another")
    prof = profile(activities=[_activity()])
    prof.__enter__()
    return prof


def _stop(prof) -> float:
    """Stop the started profiler ``prof``; the seconds its stop held the
    GIL (the wait for the card before it does not)."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()  # releases the GIL while it waits
    t0 = time.monotonic()
    prof.__exit__(None, None, None)
    return time.monotonic() - t0


# a slice's stop holds the GIL about SLICE_HOLD_S (module docstring); a
# window's first slice is SLICE_FIRST_S long, and every slice between
# SLICE_MIN_S and SLICE_MAX_S
SLICE_HOLD_S = 0.2
SLICE_FIRST_S, SLICE_MIN_S, SLICE_MAX_S = 0.02, 0.005, 1.0


class _Recorder:
    """One window's profiler on the thread that opened it, stopped and
    started again in slices (module docstring)."""

    def __init__(self):
        self.thread = threading.get_ident()
        self.slices: list = []
        self.slice_s = SLICE_FIRST_S
        self._prof = _open()
        self._t0 = time.monotonic()

    def poll(self) -> None:
        """Begin the next slice once this one is ``slice_s`` long."""
        if time.monotonic() - self._t0 >= self.slice_s:
            self._cut()
            self._prof = _open()
            self._t0 = time.monotonic()

    def stop(self) -> list:
        """The window's stopped profilers, one a slice."""
        if self._prof is not None:
            self._cut()
        return self.slices

    def _cut(self) -> None:
        prof, self._prof = self._prof, None
        held = _stop(prof)
        self.slices.append(prof)
        self.slice_s = min(max(self.slice_s * SLICE_HOLD_S
                               / max(held, 1e-3), SLICE_MIN_S), SLICE_MAX_S)


def _write(slices: list, path: str) -> None:
    """The slices' events as one Chrome trace at ``path``: Kineto writes
    each slice, and its events are copied one at a time (each a short
    hold of the GIL), after the first slice's other keys."""
    import json

    if len(slices) == 1:
        slices[0].export_chrome_trace(path)
        return
    part = path + ".slice"
    with open(path, "w") as out:
        n = 0
        for k, prof in enumerate(slices):
            prof.export_chrome_trace(part)
            with open(part) as f:
                doc = json.load(f)
            os.remove(part)
            events = doc.pop("traceEvents", [])
            if k == 0:
                out.write("{")
                for key, value in doc.items():
                    out.write(f"{json.dumps(key)}: {json.dumps(value)}, ")
                out.write('"traceEvents": [')
            for e in events:
                out.write((",\n" if n else "\n") + json.dumps(e))
                n += 1
            del doc, events
        out.write("\n]}")


class _Window:
    """A window one thread asked the holder for."""

    def __init__(self):
        self.recorder: Optional[_Recorder] = None
        self.slices: list = []
        self.error: Optional[BaseException] = None
        self.opened = threading.Event()
        self.close = threading.Event()
        self.closed = threading.Event()


def hold_windows() -> None:
    """Make the calling thread the one that opens and closes the windows
    other threads ask for, at its ``poll_window()`` calls."""
    global _host
    with _host_lock:
        _host = threading.get_ident()


def release_windows() -> None:
    """The holder's loop is over: a window it holds open is closed, one it
    never opened is refused, and later windows open on their own threads."""
    global _host, _request
    with _host_lock:
        if _host != threading.get_ident():
            return
        _host, req, _request = None, _request, None
    if req is not None:
        _serve(req, final=True)


def poll_window() -> None:
    """The holder, between two dispatches: open the window asked for, or
    close it once its asker is done."""
    req = _request
    if req is not None and _host == threading.get_ident():
        _serve(req)


def _serve(req: _Window, final: bool = False) -> None:
    global _request
    try:
        done = final or req.close.is_set()
        if req.recorder is None and not done:
            req.recorder = _Recorder()
            req.opened.set()
            return
        if not done:
            req.recorder.poll()
            return
        if req.recorder is not None:
            req.slices = req.recorder.stop()
        else:
            req.error = RuntimeError("the holder's loop ended, or the asker "
                                     "gave up, before the window opened")
    except Exception as e:  # noqa: BLE001 - handed to the asking thread
        req.error = e
    with _host_lock:
        if _request is req:
            _request = None
    req.opened.set()
    req.closed.set()


def _ask_holder():
    """The holder's opened window for this thread, or None when there is
    no holder or this thread holds the windows."""
    global _request
    with _host_lock:
        if _host is None or _host == threading.get_ident():
            return None
        req = _request = _Window()
    if not req.opened.wait(HOST_WAIT_S):
        req.close.set()  # dropped, or closed if it opens now
        raise RuntimeError(f"the window was not opened within "
                           f"{HOST_WAIT_S:g} s (the holder polls between "
                           f"its dispatches)")
    if req.error is not None:
        raise req.error
    return req


@contextlib.contextmanager
def trace(label: str, log_dir: Optional[str] = None
          ) -> Iterator[Optional[str]]:
    """A ``torch.profiler`` trace of the enclosed block (module
    docstring); yields its directory, or None."""
    global _trace_active, _own_recorder
    target = log_dir or os.environ.get("TPU_APEX_PROFILE")
    if not target:
        yield None
        return
    with _trace_lock:
        nested = _trace_active
        if not nested:
            _trace_active = True
    if nested:
        # outside the lock: the outer window's exit must not wait on this
        # caller's block
        warnings.warn(
            f"profiling.trace({label!r}): a trace is already active in "
            f"this process; nested capture skipped (the outer window keeps "
            f"recording)", stacklevel=3)
        yield None
        return
    try:
        path = os.path.join(target, sanitize_label(label))
        os.makedirs(path, exist_ok=True)
        req = _ask_holder()
        own = _Recorder() if req is None else None
        _own_recorder = own
        try:
            yield path
        finally:
            _own_recorder = None
            if req is None:
                slices = own.stop()
            else:
                req.close.set()
                if not req.closed.wait(HOST_WAIT_S):
                    raise RuntimeError(f"the window was not closed within "
                                       f"{HOST_WAIT_S:g} s")
                if req.error is not None:
                    raise req.error
                slices = req.slices
        _write(slices, os.path.join(
            path, f"{socket.gethostname()}.{os.getpid()}.pt.trace.json"))
    finally:
        with _trace_lock:
            _trace_active = False


def sleep_sliced(seconds: float) -> None:
    """Sleep ``seconds`` in a ``trace`` block; a window the calling thread
    opened itself is cut into slices meanwhile (a holder cuts the windows
    it holds at its polls)."""
    end = time.monotonic() + seconds
    while True:
        left = end - time.monotonic()
        if left <= 0:
            return
        rec = _own_recorder
        if rec is None or rec.thread != threading.get_ident():
            time.sleep(left)
            return
        rec.poll()
        time.sleep(min(left, 0.005))
