"""The perf plane — the port of pytorch_distributed_tpu/utils/perf.py
(:1-715, ``prewarm_profiler`` included): live updates/s, FLOPs per
update and MFU, env frames/s, memory watermarks, a recapture detector, a
host-sync audit and bounded profile windows, on the roles' own stats
cadences.

- **Peaks** (``PEAK_FLOPS``, ``peak_flops_of``): dense FLOP/s per card,
  keyed by the prefix of ``torch.cuda.get_device_name()`` and by the
  compute dtype, from NVIDIA's data sheets.  The fp32 figure is the card's
  non-tensor-core rate: the port's fp32 torso runs FFMA with TF32 off,
  where the reference halves its TPU's bf16 peak (``DTYPE_PEAK_SCALE``
  :79-88).  A card not in the table gets achieved FLOP/s and no MFU row.
- **FLOPs** (``flops_of``): ``torch.utils.flop_counter.FlopCounterMode``
  over one call, which counts the matrix products and convolutions,
  forward and backward, and no elementwise work.  The roles count one
  update of their train step, and one forward per frame, on fake tensors
  (``factory.update_flops``, ``factory.frame_flops``): the kernels of the
  card are ctypes launches the counter cannot see, while the step's plain
  route runs the same products through aten.  The reference reads XLA's
  ``cost_analysis`` of its compiled program (:106-122), which also counts
  the elementwise work.
- **Rates** (``PerfMonitor``, :398-606): one integer add on the hot path
  (``note_updates``, ``note_frames``); ``drain`` turns the window into
  ``{prefix}/updates_per_s``, ``env_frames_per_s``,
  ``achieved_flops_per_s`` (the sum of both programs for a monitor that
  carries both, as the Anakin loop's does) and ``mfu``, with the role's
  gauges and ``perf/{prefix}/*`` rows.
- **Memory**: the CUDA allocator's allocated bytes, current and peak
  (``perf/{prefix}/device_live_bytes``, ``device_peak_bytes``; none in a
  process that has not used its card), and the host's RSS.
- **Recaptures** (``RetraceDetector``, :210-271): the reference counts
  the jit cache of each hot program; the port counts each CUDA graph's
  captures (``capture_count`` of ``GraphedFusedStep``, ``FusedRollout`` and
  the inference server).  The first check after work is the warm-up mark;
  a capture after it is the port's retrace.
- **Host syncs** (``TransferAudit``, :278-345): torch has no transfer
  guard; ``run`` sets CUDA's sync debug mode to "warn" around the call and
  attributes every synchronizing operation of the calling thread to its
  innermost frame outside torch.  A sync is seen while the call runs,
  after kernels were launched, so the call is never run again (the
  reference retries a call its guard stopped before it ran).  The mode
  and the warning hook are process state, where the reference's guard is
  a thread's: audits that overlap on several threads (device actors
  beside the learner) share them, set by the first to enter and restored
  by the last to leave, and each sync goes to its own thread's audit.
- **Profile windows** (``run_profile_window``, :684-715): one bounded
  ``utils/profiling.trace`` at a time, asked for from any thread; while
  the learner's (or the Anakin) loop runs, its own thread opens and
  closes the window between two dispatches (``profiling.hold_windows``).
  The window is recorded in slices, so no stop of the profiler holds the
  GIL for long (utils/profiling.py).

``get_monitor`` keeps one monitor per role in the process.  Knobs:
``config.PerfParams``, each overridable as ``TPU_APEX_PERF_<FIELD>`` (the
bare ``TPU_APEX_PERF=1`` is ``enabled``); ``TPU_APEX_MXU_<FIELD>`` sets
``LearnerPerfParams`` (``resolve_mxu``).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import traceback
import warnings
from typing import Any, Callable, Dict, List, Optional

import torch

# dense FLOP/s per card (NVIDIA's H100 data sheet) by the prefix of
# torch.cuda.get_device_name() and the compute dtype
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989.4e12, "float32": 66.9e12},
    "NVIDIA H100 PCIe": {"bfloat16": 756e12, "float32": 51.2e12},
    "NVIDIA H100 NVL": {"bfloat16": 835e12, "float32": 60e12},
}


def peak_flops_of(kind: str, compute_dtype: Optional[str] = None
                  ) -> Optional[float]:
    """The card's dense peak for ``compute_dtype`` (the bf16 figure for
    None or a dtype the table lacks), or None for a card not in it."""
    for name, peaks in PEAK_FLOPS.items():
        if kind.lower().startswith(name.lower()):
            return peaks.get(str(compute_dtype), peaks["bfloat16"])
    return None


def device_kind() -> str:
    """The name of this process's CUDA device, or "cpu" when it has not
    used one."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.get_device_name(torch.cuda.current_device())
    return "cpu"


def flops_of(fn: Callable, *args, **kwargs) -> float:
    """The FLOPs of one call ``fn(*args, **kwargs)`` as
    ``FlopCounterMode`` counts them: matrix products and convolutions,
    forward and backward."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


# ---------------------------------------------------------------------------
# knob resolution (config.PerfParams + TPU_APEX_PERF_* overrides)
# ---------------------------------------------------------------------------

_ENV_PREFIX = "TPU_APEX_PERF_"
_MXU_PREFIX = "TPU_APEX_MXU_"


def _flag(raw: str) -> bool:
    return raw.strip().lower() not in ("0", "false", "off", "no", "")


def resolve(pp=None):
    """``PerfParams`` with the ``TPU_APEX_PERF_<FIELD>`` overrides of the
    environment applied, and the bare ``TPU_APEX_PERF`` as ``enabled``;
    a new instance, the input is not changed."""
    from pytorch_distributed_tpu_torch.config import PerfParams

    if pp is None:
        pp = PerfParams()
    changes: Dict[str, Any] = {}
    raw_on = os.environ.get("TPU_APEX_PERF")
    if raw_on is not None:
        changes["enabled"] = _flag(raw_on)
    for f in dataclasses.fields(pp):
        raw = os.environ.get(_ENV_PREFIX + f.name.upper())
        if raw is None:
            continue
        cur = getattr(pp, f.name)
        if isinstance(cur, bool):
            changes[f.name] = _flag(raw)
        elif isinstance(cur, int):
            changes[f.name] = int(float(raw))
        else:
            changes[f.name] = float(raw)
    return dataclasses.replace(pp, **changes) if changes else pp


def resolve_mxu(lp=None):
    """``LearnerPerfParams`` with the ``TPU_APEX_MXU_<FIELD>`` overrides of
    the environment applied (``TPU_APEX_MXU_MEGABATCH``,
    ``TPU_APEX_MXU_PALLAS_TORSO``; reference :163-187); a new instance,
    the input is not changed.  Spawn children inherit the environment, so
    every process resolves the same knobs."""
    from pytorch_distributed_tpu_torch.config import LearnerPerfParams

    if lp is None:
        lp = LearnerPerfParams()
    changes: Dict[str, Any] = {}
    for f in dataclasses.fields(lp):
        raw = os.environ.get(_MXU_PREFIX + f.name.upper())
        if raw is None:
            continue
        if isinstance(getattr(lp, f.name), bool):
            changes[f.name] = _flag(raw)
        else:
            changes[f.name] = int(float(raw))
    return dataclasses.replace(lp, **changes) if changes else lp


def export_env(pp) -> None:
    """Export a resolved ``PerfParams`` for spawn children (reference
    :190-203): ``setdefault``, so an explicit environment wins."""
    if pp.enabled:
        os.environ.setdefault("TPU_APEX_PERF", "1")
    for f in dataclasses.fields(pp):
        val = getattr(pp, f.name)
        if val != f.default:
            os.environ.setdefault(_ENV_PREFIX + f.name.upper(),
                                  ("1" if val is True else
                                   "0" if val is False else str(val)))


# ---------------------------------------------------------------------------
# recapture detector
# ---------------------------------------------------------------------------

class RetraceDetector:
    """Counts the captures of each registered CUDA graph and flags growth
    after the warm-up mark.  ``register(name, count_fn)`` takes a zero-arg
    callable returning the graph owner's capture count; one returning
    None (a program run eagerly, on the CPU) is skipped at that check.
    The first ``check`` marks the warm-up; any growth a later check sees
    is counted once, under the graph's name, in ``fired``."""

    def __init__(self):
        self._fns: Dict[str, Callable[[], Optional[int]]] = {}
        self._warm: Dict[str, int] = {}
        self._warmed = False
        self.retraces = 0
        self.fired: Dict[str, int] = {}

    def register(self, name: str,
                 size_fn: Optional[Callable[[], Optional[int]]]) -> None:
        if size_fn is not None:
            self._fns[name] = size_fn

    def _sizes(self) -> Dict[str, int]:
        out = {}
        for name, fn in self._fns.items():
            try:
                size = fn()
            except Exception:  # noqa: BLE001 - a dead owner must not kill perf
                size = None
            if size is not None:
                out[name] = int(size)
        return out

    def mark_warm(self) -> None:
        self._warm = self._sizes()
        self._warmed = True

    def check(self) -> List[str]:
        """The graphs captured again since the last check."""
        if not self._warmed:
            self.mark_warm()
            return []
        fired = []
        for name, size in self._sizes().items():
            prev = self._warm.get(name)
            if prev is None:
                self._warm[name] = size  # registered late: its own warm-up
                continue
            if size > prev:
                grew = size - prev
                self.retraces += grew
                self.fired[name] = self.fired.get(name, 0) + grew
                self._warm[name] = size
                fired.append(name)
        return fired


# ---------------------------------------------------------------------------
# host-sync audit
# ---------------------------------------------------------------------------

# the head of the warning CUDA's sync debug mode raises
SYNC_WARNING = "called a synchronizing CUDA operation"


def _is_sync_warning(message) -> bool:
    return SYNC_WARNING.lower() in str(message).lower()


def _frame_site(frames) -> Optional[str]:
    """The innermost frame outside torch (the reference's ``_frame_site``
    rule)."""
    site = None
    for fr in frames:
        path = fr.filename.replace(os.sep, "/")
        if "/torch/" in path or path.endswith(("utils/perf.py",
                                               "/warnings.py")):
            continue
        site = f"{fr.filename}:{fr.lineno} ({fr.name})"
    return site


class _SyncWatch:
    """The process-wide half of every audit: the warning filter and hook,
    and CUDA's sync debug mode.  The first audit to enter sets them, the
    last to leave restores them; in between, a sync warning goes to the
    innermost audit running on the thread that raised it, and a sync of a
    thread with no audit running is dropped."""

    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0
        self._sinks: Dict[int, List[list]] = {}  # thread id -> hit lists
        self._saved: Optional[warnings.catch_warnings] = None
        self._shown: Optional[Callable] = None
        self._prev_mode = None

    def enter(self) -> list:
        hits: list = []
        with self._lock:
            if self._depth == 0:
                self._saved = warnings.catch_warnings()
                self._saved.__enter__()
                # every sync, not the first one a line
                warnings.filterwarnings("always", message=SYNC_WARNING)
                self._shown = warnings.showwarning
                warnings.showwarning = self._hook
            if (self._prev_mode is None and torch.cuda.is_available()
                    and torch.cuda.is_initialized()):
                self._prev_mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
            self._depth += 1
            self._sinks.setdefault(threading.get_ident(), []).append(hits)
        return hits

    def leave(self) -> None:
        tid = threading.get_ident()
        with self._lock:
            stack = self._sinks[tid]
            stack.pop()  # a thread's audits nest
            if not stack:
                del self._sinks[tid]
            self._depth -= 1
            if self._depth == 0:
                if self._prev_mode is not None:
                    torch.cuda.set_sync_debug_mode(self._prev_mode)
                    self._prev_mode = None
                self._saved.__exit__(None, None, None)
                self._saved = self._shown = None

    def _hook(self, message, category, filename, lineno, file=None,
              line=None):
        if _is_sync_warning(message):
            stack = self._sinks.get(threading.get_ident())
            if stack:
                stack[-1].append((_frame_site(traceback.extract_stack())
                                  or f"{filename}:{lineno}", str(message)))
            return
        # restored already when None: the module's is the one before
        (self._shown or warnings.showwarning)(message, category, filename,
                                              lineno, file, line)


_sync_watch = _SyncWatch()


class TransferAudit:
    """Attributes the host syncs of an audited call to their call sites
    (module docstring).  ``total`` counts them, ``sites`` by
    ``file:line (function)``, the innermost frame outside torch;
    ``last_error`` is the newest warning's text.  The first hit at a site
    is printed.  Syncs of other threads during the call are not the
    call's and are dropped; audits on several threads may overlap."""

    def __init__(self):
        self.total = 0
        self.sites: Dict[str, int] = {}
        self.last_error: Optional[str] = None

    def _note(self, site: str, message: str) -> None:
        first = site not in self.sites
        self.total += 1
        self.sites[site] = self.sites.get(site, 0) + 1
        self.last_error = message.splitlines()[0][:300]
        if first:  # one line a site, not a line a dispatch
            print(f"[perf] transfer audit: host sync on an audited hot "
                  f"path at {site}: {self.last_error}", flush=True)

    def run(self, fn, *args, **kwargs):
        hits = _sync_watch.enter()
        try:
            return fn(*args, **kwargs)
        finally:
            _sync_watch.leave()
            for site, message in hits:
                self._note(site, message)


# ---------------------------------------------------------------------------
# host and device memory watermarks
# ---------------------------------------------------------------------------

def host_rss_bytes() -> Optional[int]:
    """This process's resident set size (Linux /proc)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


def host_peak_rss_bytes() -> Optional[int]:
    """The process's lifetime peak RSS (``ru_maxrss`` is KiB on Linux)."""
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except (ImportError, OSError):
        return None


def device_memory_watermarks() -> Dict[str, float]:
    """The CUDA allocator's allocated bytes on this process's card, now
    and at their peak; empty in a process that has not used a card."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return {}
    stats = torch.cuda.memory_stats()
    out: Dict[str, float] = {}
    live = stats.get("allocated_bytes.all.current")
    peak = stats.get("allocated_bytes.all.peak")
    if live is not None:
        out["device_live_bytes"] = float(live)
    if peak is not None:
        out["device_peak_bytes"] = float(peak)
    return out


# ---------------------------------------------------------------------------
# the monitor
# ---------------------------------------------------------------------------

class PerfMonitor:
    """One role's performance accounting (module docstring).  The hot path
    is ``note_updates``/``note_frames``, which do nothing when the plane is
    off; ``drain`` derives everything on the role's stats cadence and
    returns ``{tag: value}`` for its ``MetricsWriter``; ``last`` keeps the
    newest drain for ``status_snapshot``."""

    def __init__(self, name: str, params=None, prefix: Optional[str] = None):
        self.name = name
        # "actor-3" -> "actor": tags compare across the fleet, the
        # writer's role stamp says which process wrote the row
        self.prefix = prefix if prefix is not None else name.split("-")[0]
        self.params = resolve(params)
        self.enabled = self.params.enabled
        self.flops_per_update: Optional[float] = None
        self.flops_per_frame: Optional[float] = None
        # the role's compute dtype picks the peak; set before the first
        # drain.  An explicit peak_flops is used as it is
        self.compute_dtype: Optional[str] = None
        self._peak: Optional[float] = None
        self._peak_resolved = False
        self.retraces = RetraceDetector()
        self.audit = (TransferAudit()
                      if self.enabled and self.params.transfer_audit
                      else None)
        self._updates = 0
        self._frames = 0
        self._gauges: Dict[str, float] = {}
        self._anchor: Optional[tuple] = None  # (mono, updates, frames)
        self._flops_reported = False
        self.last: Dict[str, float] = {}

    # -- start-up counts -------------------------------------------------

    def capture_flops(self, count: Callable[[], float]) -> Optional[float]:
        """Keep ``count()``, the FLOPs of one update.  A count that fails
        leaves MFU off and says so."""
        if not self.enabled:
            return None
        try:
            flops = count()
            self.flops_per_update = float(flops) if flops else None
            if not flops:
                print(f"[perf] {self.name}: the update counted no FLOPs; "
                      f"mfu reporting disabled", flush=True)
        except Exception as e:  # noqa: BLE001 - a count never stops a role
            print(f"[perf] {self.name}: flops capture failed ({e!r}); "
                  f"mfu reporting disabled", flush=True)
            self.flops_per_update = None
        return self.flops_per_update

    def capture_frame_flops(self, count: Callable[[], float],
                            frames_per_call: int) -> Optional[float]:
        """Keep the FLOPs per env frame of a program whose call, counted by
        ``count()``, makes ``frames_per_call`` frames."""
        if not self.enabled:
            return None
        try:
            total = count()
            self.flops_per_frame = (float(total) / frames_per_call
                                    if total else None)
        except Exception as e:  # noqa: BLE001 - a count never stops a role
            print(f"[perf] {self.name}: frame-flops capture failed "
                  f"({e!r}); rollout mfu reporting disabled", flush=True)
            self.flops_per_frame = None
        return self.flops_per_frame

    def register_jit(self, name: str,
                     size_fn: Optional[Callable[[], Optional[int]]]) -> None:
        """Watch a CUDA graph's capture count (the reference's name: there
        the count is a jit cache's size)."""
        if self.enabled and self.params.retrace_detector:
            self.retraces.register(name, size_fn)

    # -- hot path ----------------------------------------------------------

    def note_updates(self, n: int) -> None:
        if self.enabled:
            self._updates += n

    def note_frames(self, n: int) -> None:
        if self.enabled:
            self._frames += n

    def set_gauge(self, tag: str, value: float) -> None:
        if self.enabled:
            self._gauges[tag] = float(value)

    # -- cadence -----------------------------------------------------------

    def set_compute_dtype(self, dtype) -> None:
        """The dtype the peak is read for ("bfloat16", "float32"; a
        ``torch.dtype`` is named), until the first drain resolves it."""
        if self.enabled and not self._peak_resolved:
            if isinstance(dtype, torch.dtype):
                dtype = str(dtype).replace("torch.", "")
            self.compute_dtype = str(dtype) if dtype is not None else None

    def _peak_flops(self) -> Optional[float]:
        if not self._peak_resolved:
            self._peak_resolved = True
            if self.params.peak_flops > 0:
                self._peak = float(self.params.peak_flops)
            else:
                kind = device_kind()
                self._peak = peak_flops_of(kind, self.compute_dtype)
                if self._peak is None:
                    print(f"[perf] {self.name}: no peak FLOP/s for "
                          f"{kind!r} (utils/perf.PEAK_FLOPS); achieved "
                          f"FLOP/s only, no mfu row (set "
                          f"TPU_APEX_PERF_PEAK_FLOPS)", flush=True)
        return self._peak

    def drain(self, step: int = 0, now: Optional[float] = None
              ) -> Dict[str, float]:
        """The window's rates and derived rows since the previous drain
        (reference :526-593); the first call anchors the window and
        returns no rate."""
        if not self.enabled:
            return {}
        if now is None:
            now = time.monotonic()
        out: Dict[str, float] = {}
        anchor = self._anchor
        self._anchor = (now, self._updates, self._frames)
        if anchor is not None and now > anchor[0]:
            dt = now - anchor[0]
            d_up = self._updates - anchor[1]
            d_fr = self._frames - anchor[2]
            # the sum of the update- and the frame-denominated programs:
            # a monitor that carries both (the Anakin loop) reports the
            # card's whole use
            achieved = 0.0
            if self._updates or d_up:
                ups = d_up / dt
                out[f"{self.prefix}/updates_per_s"] = ups
                if self.flops_per_update:
                    achieved += ups * self.flops_per_update
            if self._frames or d_fr:
                fps = d_fr / dt
                out[f"{self.prefix}/env_frames_per_s"] = fps
                if self.flops_per_frame:
                    achieved += fps * self.flops_per_frame
            if achieved:
                out[f"{self.prefix}/achieved_flops_per_s"] = achieved
                peak = self._peak_flops()
                if peak:
                    out[f"{self.prefix}/mfu"] = achieved / peak
        if self.flops_per_update and not self._flops_reported:
            self._flops_reported = True
            out[f"{self.prefix}/flops_per_update"] = self.flops_per_update
        out.update(self._gauges)
        if self.params.memory_watermarks:
            rss = host_rss_bytes()
            if rss is not None:
                out[f"perf/{self.prefix}/rss_bytes"] = float(rss)
            peak_rss = host_peak_rss_bytes()
            if peak_rss is not None:
                out[f"perf/{self.prefix}/rss_peak_bytes"] = float(peak_rss)
            for k, v in device_memory_watermarks().items():
                out[f"perf/{self.prefix}/{k}"] = v
        if self.params.retrace_detector and self.retraces._fns \
                and (self._updates or self._frames):
            # after work only: the warm-up mark must follow the first
            # dispatches' captures
            fired = self.retraces.check()
            if fired:
                print(f"[perf] {self.name}: CUDA graph recaptured after "
                      f"warm-up: {', '.join(fired)}", flush=True)
            out[f"perf/{self.prefix}/retraces"] = float(
                self.retraces.retraces)
        if self.audit is not None:
            out[f"perf/{self.prefix}/transfers_flagged"] = float(
                self.audit.total)
        self.last = dict(out)
        return out

    def snapshot(self) -> Dict[str, float]:
        """The newest drain plus the running counts (no derivation, no
        reset: safe from any thread)."""
        snap = dict(self.last)
        snap["updates_total"] = float(self._updates)
        snap["frames_total"] = float(self._frames)
        if self.flops_per_update:
            snap[f"{self.prefix}/flops_per_update"] = self.flops_per_update
        if self.flops_per_frame:
            snap[f"{self.prefix}/flops_per_frame"] = self.flops_per_frame
        return snap


# ---------------------------------------------------------------------------
# the process's monitors
# ---------------------------------------------------------------------------

_registry_lock = threading.Lock()
_monitors: Dict[str, PerfMonitor] = {}


def get_monitor(name: str, params=None,
                prefix: Optional[str] = None) -> PerfMonitor:
    with _registry_lock:
        m = _monitors.get(name)
        if m is None:
            m = _monitors[name] = PerfMonitor(name, params=params,
                                              prefix=prefix)
        return m


def status_snapshot() -> Dict[str, Dict[str, float]]:
    """``{role: snapshot}`` of every enabled monitor of this process that
    has seen work."""
    with _registry_lock:
        monitors = list(_monitors.values())
    return {m.name: m.snapshot() for m in monitors
            if m.enabled and (m.last or m._updates or m._frames)}


def reset() -> None:
    """Drop every monitor (test isolation)."""
    with _registry_lock:
        _monitors.clear()


# ---------------------------------------------------------------------------
# profile windows
# ---------------------------------------------------------------------------

_profile_lock = threading.Lock()


def prewarm_profiler() -> float:
    """Pay the profiler's one-time set-up now (reference :646-681): a
    throwaway window of 50 ms into a temp dir, under the one-window lock,
    so a window asked for later (``T_PROFILE``) opens at window speed.
    The reference warms on a background thread; the port's first trace
    must begin on the thread that imported torch (utils/profiling.py), so
    it warms on the calling thread, which must be the main one, and
    returns the seconds it took."""
    import shutil
    import tempfile

    from pytorch_distributed_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    with _profile_lock:
        tmp = tempfile.mkdtemp(prefix="perf_profiler_warm_")
        try:
            profiling.init_profiler()
            with profiling.trace("_warmup", log_dir=tmp):
                time.sleep(0.05)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return time.perf_counter() - t0


def run_profile_window(trace_dir: str, label: str = "tprofile",
                       seconds: float = 3.0,
                       max_seconds: Optional[float] = None
                       ) -> Dict[str, Any]:
    """One ``profiling.trace`` window of this process's device activity,
    ``seconds`` long (clamped to [0.05, ``max_seconds``], by default
    ``PerfParams.profile_window_max`` as ``resolve`` gives it, the bound
    the reference's fleet passes), into ``trace_dir``:
    ``{"trace_dir", "seconds"}``, or ``{"error"}``.  It
    blocks its caller, a thread of its own (a window the learner's loop
    holds waits ``profiling.HOST_WAIT_S`` at most to open and to close);
    a second window while one is open gets the error, not a nested
    capture."""
    from pytorch_distributed_tpu_torch.utils import profiling

    try:
        seconds = float(seconds)
    except (TypeError, ValueError):
        return {"error": f"bad seconds value {seconds!r}"}
    if max_seconds is None:
        max_seconds = resolve().profile_window_max
    seconds = max(0.05, min(seconds, max_seconds))
    if not _profile_lock.acquire(blocking=False):
        return {"error": "a profile window is already active"}
    try:
        with profiling.trace(str(label), log_dir=trace_dir) as path:
            if path is None:
                return {"error": "profiler unavailable (a trace is "
                                 "already active in this process)"}
            profiling.sleep_sliced(seconds)
        return {"trace_dir": path, "seconds": seconds}
    except Exception as e:  # noqa: BLE001 - reported to the caller
        return {"error": f"profile capture failed: {e!r}"}
    finally:
        _profile_lock.release()
