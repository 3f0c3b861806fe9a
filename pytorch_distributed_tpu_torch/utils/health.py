"""Training health sentinel — the port of
pytorch_distributed_tpu/utils/health.py: the env overrides (``resolve``
:73, ``quarantine_active`` :94), the host PER X-ray (``priority_xray``
:196), the anomaly detector (``_Ewma``, ``AnomalyDetector`` :232-345),
the ``poison_chunk`` payload (``poison_items`` :352), the ingest
validator (``ChunkValidator`` :381-506) and the quarantine sinks
(``QuarantineStore``, ``get_quarantine``, ``quarantine_counts``
:509-640).

The in-step finite guard is ``ops/losses.build_dqn_train_step``'s (its
``SKIPPED_KEY`` is ``learner/skipped``); this module is the host half of
the detection -> containment -> recovery ladder:

- ``AnomalyDetector`` runs on the learner's stats cadence: the loss's
  EWMA z-score, the grad norm's spike ratio, the skipped-step count and
  the PER X-ray's priority collapse.  Past ``anomaly_threshold``
  consecutive anomalous windows the learner rolls back to an older
  checkpoint epoch (agents/learner.py), at most ``max_rollbacks`` times.
- ``ChunkValidator`` and ``QuarantineStore`` run in the ingest's drain
  (memory/device_replay.py): a non-finite or malformed row goes to
  ``{log_dir}/quarantine/<source>-<n>.npz`` instead of into the ring.

Every ``HealthParams`` field is overridable as ``TPU_APEX_HEALTH_<FIELD>``
and ``TPU_APEX_QUARANTINE=0`` turns the validation off, as in the JAX
package.  The port carries no provenance or trace ids yet, so a
quarantine file's ``prov`` rows are the reference's "unknown" sentinel
(-1) and its ``trace_id`` is 0.
"""

from __future__ import annotations

import dataclasses
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pytorch_distributed_tpu_torch.utils import flight_recorder
from pytorch_distributed_tpu_torch.utils.experience import REPLAY_FIELDS

_ENV_PREFIX = "TPU_APEX_HEALTH_"
_OFF = ("0", "false", "off", "no", "")

# the fixed log10 bucket grid of the X-ray, shared with the device twin
# (memory/device_per.priority_xray_device)
PRIORITY_XRAY_LOG10_LO = -6.0
PRIORITY_XRAY_LOG10_HI = 3.0

# the provenance columns a quarantine file carries; the port's rows have
# none, which the reference writes as -1
_PROV_COLUMNS = 4


def resolve(hp) -> Any:
    """A new HealthParams with the ``TPU_APEX_HEALTH_<FIELD>`` overrides
    applied (bools by the reference's off words, ints through float, the
    rest as floats); the input is never changed."""
    changes = {}
    for f in dataclasses.fields(hp):
        raw = os.environ.get(_ENV_PREFIX + f.name.upper())
        if raw is None:
            continue
        cur = getattr(hp, f.name)
        if isinstance(cur, bool):
            changes[f.name] = raw.strip().lower() not in _OFF
        elif isinstance(cur, int):
            changes[f.name] = int(float(raw))
        else:
            changes[f.name] = float(raw)
    return dataclasses.replace(hp, **changes) if changes else hp


def quarantine_active() -> bool:
    """Whether the ingest validation is on in this process (default on;
    ``TPU_APEX_QUARANTINE=0`` turns it off)."""
    raw = os.environ.get("TPU_APEX_QUARANTINE")
    return True if raw is None else raw.strip().lower() not in _OFF


def priority_xray(leaves, bins: int = 16) -> Optional[Dict[str, Any]]:
    """A PER leaf vector (``p ** alpha``) summarised: a histogram over the
    fixed [1e-6, 1e3) log10 grid, the effective sample size ``(sum p)^2 /
    sum p^2`` and its fraction of the non-empty rows.  None when no leaf
    is positive."""
    p = np.asarray(leaves, dtype=np.float64)
    p = p[p > 0]
    if p.size == 0:
        return None
    s1, s2 = float(p.sum()), float((p * p).sum())
    ess = (s1 * s1 / s2) if s2 > 0 else 0.0
    logp = np.log10(np.maximum(p, 10.0 ** PRIORITY_XRAY_LOG10_LO))
    t = (logp - PRIORITY_XRAY_LOG10_LO) / (
        PRIORITY_XRAY_LOG10_HI - PRIORITY_XRAY_LOG10_LO)
    b = np.clip((t * bins).astype(np.int64), 0, bins - 1)
    counts = np.bincount(b, minlength=bins)[:bins]
    return {
        "rows": int(p.size),
        "mass": s1,
        "ess": ess,
        "ess_frac": ess / p.size,
        "counts": counts,
        "log10_lo": PRIORITY_XRAY_LOG10_LO,
        "log10_hi": PRIORITY_XRAY_LOG10_HI,
        "p_max": float(p.max()),
    }


class _Ewma:
    """Exponentially weighted mean and variance with a sample count."""

    def __init__(self, decay: float = 0.97):
        self.decay = decay
        self.n = 0
        self.mean = 0.0
        self.var = 0.0

    def update(self, x: float) -> None:
        self.n += 1
        if self.n == 1:
            self.mean = x
            return
        d = x - self.mean
        self.mean += (1.0 - self.decay) * d
        self.var = self.decay * (self.var + (1.0 - self.decay) * d * d)

    @property
    def std(self) -> float:
        return math.sqrt(max(self.var, 0.0))


class AnomalyDetector:
    """The divergence detector fed once a stats window.  ``observe``
    returns the labels the window tripped (empty: healthy) and keeps the
    streak of consecutive anomalous windows; ``should_rollback`` is true
    once the streak reaches ``threshold``.  Labels:

    - ``nonfinite``: the loss or grad norm (or TD) is NaN or infinite;
    - ``skipped``: the in-step guard skipped at least one step;
    - ``loss_spike``: the loss's z-score against its EWMA above ``zmax``;
    - ``grad_spike`` / ``td_explosion``: the grad norm / mean |TD| above
      ``grad_spike`` times its EWMA;
    - ``priority_collapse``: the ring holds rows but its priority mass is
      about 0, or the X-ray's ESS / rows fell under ``ess_floor``.

    No spike label trips before a signal has ``WARMUP`` samples, and an
    anomalous reading never enters its own baseline."""

    WARMUP = 8

    def __init__(self, zmax: float = 8.0, grad_spike: float = 100.0,
                 threshold: int = 3, ess_floor: float = 0.02):
        self.zmax = zmax
        self.grad_spike = grad_spike
        self.ess_floor = ess_floor
        self.threshold = max(1, int(threshold))
        self.loss = _Ewma()
        self.grad = _Ewma()
        self.td = _Ewma()
        self.streak = 0
        self.windows = 0
        self.anomalies_total = 0

    def observe(self, loss: Optional[float] = None,
                grad_norm: Optional[float] = None,
                td_mean: Optional[float] = None,
                priority_mass: Optional[float] = None,
                replay_rows: int = 0,
                skipped: float = 0.0,
                priority_ess: Optional[float] = None) -> List[str]:
        self.windows += 1
        out: List[str] = []
        if skipped and skipped > 0:
            out.append("skipped")
        for val, ewma, spike_label in ((loss, self.loss, "loss_spike"),
                                       (grad_norm, self.grad, "grad_spike"),
                                       (td_mean, self.td, "td_explosion")):
            if val is None:
                continue
            if not math.isfinite(val):
                if "nonfinite" not in out:
                    out.append("nonfinite")
                continue
            warm = ewma.n >= self.WARMUP
            if warm and spike_label == "loss_spike":
                z = abs(val - ewma.mean) / max(ewma.std, 1e-12)
                if z > self.zmax:
                    out.append(spike_label)
            elif warm and abs(val) > self.grad_spike * max(
                    abs(ewma.mean), 1e-12):
                out.append(spike_label)
            if spike_label not in out:
                ewma.update(val)
        if replay_rows > 0 and (
                (priority_mass is not None and priority_mass <= 1e-12)
                or (priority_ess is not None
                    and priority_ess < self.ess_floor)):
            out.append("priority_collapse")
        self.streak = self.streak + 1 if out else 0
        self.anomalies_total += len(out)
        return out

    def should_rollback(self) -> bool:
        return self.streak >= self.threshold

    def reset(self) -> None:
        """After a rollback: the streak and the baselines start over (the
        restored epoch's loss scale may differ from the diverged
        tail's)."""
        self.loss = _Ewma()
        self.grad = _Ewma()
        self.td = _Ewma()
        self.streak = 0


def poison_items(items):
    """The ``poison_chunk`` fault's payload over ``[(Transition, priority),
    ...]``: rewards and priorities go NaN, and float observations too
    (uint8 frames cannot hold NaN, so pixel rows are poisoned through
    their scalars).  Returns a new list."""
    out = []
    for t, _p in items:
        repl = {"reward": np.asarray(t.reward).dtype.type(np.nan)}
        s0 = np.asarray(t.state0)
        if s0.dtype.kind == "f":
            repl["state0"] = np.full_like(s0, np.nan)
        out.append((t._replace(**repl), float("nan")))
    return out


def _finite_scalar(x) -> bool:
    try:
        return bool(np.isfinite(x))
    except TypeError:
        return False


class ChunkValidator:
    """The ingest's per-row validator over ``(Transition, priority)``
    items: a non-finite or negative priority; a non-finite reward,
    ``gamma_n`` or ``terminal1``; a state whose shape or dtype drifted
    from the expected schema (the ring's own, or the first row's); a
    non-finite float state (integer states such as config 12's uint8
    frames cannot hold NaN and skip the scan); a non-finite float action
    or a discrete action outside ``[0, num_actions)``.

    The six-column ``Transition`` rows only: the R2D2 ``Segment`` rows of
    the reference's validator wait for the sequence replay's port
    (ROADMAP Queue A item 8)."""

    def __init__(self, state_shape: Optional[Tuple[int, ...]] = None,
                 state_dtype=None, num_actions: Optional[int] = None):
        self.state_shape = tuple(state_shape) if state_shape else None
        self.state_dtype = np.dtype(state_dtype) if state_dtype else None
        self.num_actions = num_actions
        self.checked = 0
        self.rejected = 0

    def _check(self, t, priority) -> Optional[str]:
        if priority is not None and (
                not _finite_scalar(priority) or float(priority) < 0.0):
            return f"invalid priority {priority!r}"
        for name in ("reward", "gamma_n", "terminal1"):
            if not _finite_scalar(getattr(t, name)):
                return f"non-finite {name}"
        for name in ("state0", "state1"):
            arr = np.asarray(getattr(t, name))
            if self.state_shape is None:
                self.state_shape = arr.shape
            elif arr.shape != self.state_shape:
                return (f"{name} shape {arr.shape} != "
                        f"expected {self.state_shape}")
            if self.state_dtype is None:
                self.state_dtype = arr.dtype
            elif arr.dtype != self.state_dtype:
                return (f"{name} dtype {arr.dtype} != "
                        f"expected {self.state_dtype}")
            if arr.dtype.kind == "f" and not np.isfinite(arr).all():
                return f"non-finite {name}"
        a = np.asarray(t.action)
        if a.dtype.kind == "f" and not np.isfinite(a).all():
            return "non-finite action"
        if (self.num_actions is not None and a.dtype.kind in "iu"
                and a.size and not ((a >= 0) & (a < self.num_actions)).all()):
            return f"action out of range [0, {self.num_actions})"
        return None

    def filter(self, items) -> Tuple[list, List[Tuple[Any, Optional[float],
                                                      str]]]:
        """``(clean items, [(transition, priority, reason), ...])``; with
        nothing rejected the clean list is ``items`` itself."""
        self.checked += len(items)
        bad: List[Tuple[Any, Optional[float], str]] = []
        good: list = []
        for t, p in items:
            reason = self._check(t, p)
            if reason is None:
                good.append((t, p))
            else:
                bad.append((t, p, reason))
        self.rejected += len(bad)
        if not bad:
            return items, bad
        return good, bad


class QuarantineStore:
    """One ingest source's quarantine: rejected rows land in
    ``{log_dir}/quarantine/<source>-<n>.npz`` (the six columns stacked
    where they stack, ``priority``, ``reason``, ``trace_id``, ``prov``,
    ``wall`` and the run id) instead of the ring.  The directory is the
    flight recorder's (``configure`` or ``TPU_APEX_BLACKBOX_DIR``).  Past
    ``max_files`` files the store only counts, so a poisoning actor
    cannot fill the disk."""

    def __init__(self, source: str, max_files: int = 64):
        self.source = source
        self.max_files = max_files
        self.count = 0       # rows quarantined
        self.files = 0       # files written
        self._lock = threading.Lock()

    def put(self, rejected, trace_id: int = 0) -> Optional[str]:
        """Record ``[(transition, priority, reason), ...]``; returns the
        path written, or None when no log dir is known, the file budget
        is spent or the write failed (the rows are counted either
        way)."""
        if not rejected:
            return None
        with self._lock:
            self.count += len(rejected)
            n = self.files
            if n >= self.max_files:
                return None
            self.files += 1
        base = flight_recorder._dump_dir()
        if not base:
            return None
        target = os.path.join(base, "quarantine")
        cols: Dict[str, np.ndarray] = {}
        for f in REPLAY_FIELDS:
            vals = [np.asarray(getattr(t, f)) for t, _p, _r in rejected]
            try:
                cols[f] = np.stack(vals)
            except ValueError:  # rows whose shapes drifted do not stack
                cols[f] = np.array([str(v.shape) + ":" + str(v.dtype)
                                    for v in vals])
        cols["priority"] = np.array(
            [np.nan if p is None else float(p) for _t, p, _r in rejected],
            dtype=np.float64)
        cols["reason"] = np.array([r for _t, _p, r in rejected])
        cols["trace_id"] = np.array([f"{int(trace_id):016x}"])
        cols["prov"] = np.full((len(rejected), _PROV_COLUMNS), -1,
                               dtype=np.int64)
        cols["wall"] = np.array([time.time()], dtype=np.float64)
        rid = flight_recorder.run_id()
        if rid:
            cols["run_id"] = np.array([rid])
        safe = "".join(c if (c.isalnum() or c in "-_.") else "_"
                       for c in self.source) or "source"
        path = os.path.join(target, f"{safe}-{n:05d}.npz")
        try:
            os.makedirs(target, exist_ok=True)
            tmp = path + ".tmp.npz"
            np.savez(tmp, **cols)
            os.replace(tmp, path)  # a reader never sees a torn file
        except OSError:
            return None
        if n == 0:  # the first file of a source is printed; the rest count
            print(f"[health] quarantined {len(rejected)} transition(s) "
                  f"from {self.source} ({rejected[0][2]}) -> {path}",
                  flush=True)
        return path


_q_lock = threading.Lock()
_q_stores: Dict[str, QuarantineStore] = {}


def get_quarantine(source: str, max_files: int = 64) -> QuarantineStore:
    """This process's store of ``source``, made on first use."""
    with _q_lock:
        st = _q_stores.get(source)
        if st is None:
            st = _q_stores[source] = QuarantineStore(source,
                                                     max_files=max_files)
        return st


def quarantine_counts() -> Dict[str, int]:
    """``{source: rows quarantined}`` over this process's stores."""
    with _q_lock:
        return {s: st.count for s, st in _q_stores.items() if st.count}


def reset() -> None:
    """Drop every quarantine store (test isolation)."""
    with _q_lock:
        _q_stores.clear()
