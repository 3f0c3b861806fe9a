"""Deterministic fault injection — the port of
pytorch_distributed_tpu/utils/faults.py (:107-305) for the planes the
port instruments: ``parse_faults`` and ``FaultInjector`` with
``from_env``, ``frame``, ``data_frame`` and the flight-recorder note
(``_note``).

An instrumented endpoint counts one frame per operation, and an event
scheduled at that frame fires.  The schedule comes from
``{ROLE}_FAULTS`` in the environment, which spawn children inherit:

- ``CKPT_FAULTS``: the epoch writer (utils/checkpoint.py ``save_epoch``),
  one frame per write point of a save;
- ``FEEDER_FAULTS``: an actor's ingest feeder, one frame per flush
  (memory/feeder.py ``QueueFeeder.flush``);
- ``LEARNER_FAULTS``: the learner, one frame per update dispatch;
- ``ACTOR_FAULTS``: an actor, one frame per vector tick (one per fused
  dispatch on the device backend).

Actions (``action@frame`` or ``action@frame:arg``):

- ``kill@N``: SIGKILL the process at frame N, as a host that loses power;
- ``crash@N``: raise ``InjectedCrash``, which no handler swallows, so the
  worker dies non-zero and its restart budget engages;
- ``hang@N[:S]``: stop progressing without exiting (forever, or S
  seconds), the failure the hang watchdog exists to catch;
- ``delay@N:S``: sleep S seconds first;
- ``poison_chunk@N`` and ``poison_grad@N``: data-plane verbs that the
  endpoint applies itself when it asks for them through ``data_frame``
  (the feeder NaNs flush N's rows; the learner NaNs the rewards of the
  host-sampled batch of dispatch N, and on a fused device ring, which
  has no host batch, prints that it is inert).  Scheduled on an endpoint
  that does not ask for them they are inert and only recorded.

Every fired event is recorded in the flight recorder, and a fatal one
(``crash``, ``kill``, ``hang``) dumps every ring of the process first:
nothing runs after a SIGKILL.  The wire verbs (``sever``, ``blackhole``,
``corrupt``) and the ``random:SEED`` schedules wait for the fleet planes
(ROADMAP Queue A item 10).
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Dict, Iterable, List, Tuple

from pytorch_distributed_tpu_torch.utils import flight_recorder

FaultEvent = Tuple[int, str, float]  # (frame index, action, arg)

_ACTIONS = ("delay", "crash", "kill", "poison_chunk", "poison_grad", "hang")


class InjectedCrash(RuntimeError):
    """A fault-injected process death: not a ConnectionError, so no
    transport handler swallows it and the worker exits non-zero."""


def parse_faults(spec: str) -> List[FaultEvent]:
    """``"kill@5,delay@3:0.5"`` -> [(5, "kill", 0.0), (3, "delay", 0.5)].
    Raises ValueError on a malformed spec: a drill that silently injects
    nothing proves nothing."""
    events: List[FaultEvent] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            action, rest = part.split("@", 1)
            if ":" in rest:
                at_s, arg_s = rest.split(":", 1)
                at, arg = int(at_s), float(arg_s)
            else:
                at, arg = int(rest), 0.0
        except ValueError as e:
            raise ValueError(f"bad fault event {part!r} "
                             f"(want action@frame[:arg])") from e
        if action not in _ACTIONS:
            raise ValueError(f"unknown fault action {action!r} "
                             f"(known: {_ACTIONS})")
        events.append((at, action, arg))
    return events


class FaultInjector:
    """One injector per instrumented endpoint.  ``frame()`` counts one
    operation and fires the events scheduled at its index; thread-safe,
    so the count is one order over every caller."""

    def __init__(self, events: Iterable[FaultEvent] = (), name: str = ""):
        self.name = name
        self._lock = threading.Lock()
        self._n = 0
        self._by_frame: Dict[int, List[Tuple[str, float]]] = {}
        for at, action, arg in events:
            self._by_frame.setdefault(at, []).append((action, arg))
        self.injected = 0  # events fired so far

    @classmethod
    def from_env(cls, role: str) -> "FaultInjector":
        """The schedule in ``{ROLE}_FAULTS``; unset or empty: an injector
        that fires nothing."""
        spec = os.environ.get(f"{role.upper()}_FAULTS", "").strip()
        if spec.startswith("random:"):
            raise ValueError(f"{role.upper()}_FAULTS={spec!r}: random "
                             f"schedules are not ported (ROADMAP Queue A "
                             f"item 10)")
        return cls(parse_faults(spec), name=role)

    def _note(self, action: str, frame: int, fatal: bool) -> None:
        """Record the event in the flight recorder; a fatal one also dumps
        every ring of this process now."""
        flight_recorder.get_recorder(f"faults-{self.name or 'anon'}").record(
            "fault", action=action, frame=frame)
        if fatal:
            flight_recorder.dump_all(f"injected {action} at frame {frame} "
                                     f"(faults:{self.name})")

    def frame(self) -> None:
        """Account one operation; fire its scheduled events."""
        self.data_frame(())

    def data_frame(self, want: Tuple[str, ...] = ()
                   ) -> List[Tuple[str, float]]:
        """Account one data-plane operation (a feeder flush, a learner
        dispatch, an actor tick): fire the events scheduled at it as
        ``frame`` does, and return the fired ones named in ``want``, which
        the caller applies itself."""
        with self._lock:
            n = self._n
            self._n += 1
            events = self._by_frame.get(n)
        hits: List[Tuple[str, float]] = []
        for action, arg in events or ():
            if action.startswith("poison") and action not in want:
                self._note(action, n, fatal=False)
                continue
            self.injected += 1
            self._note(action, n, fatal=action in ("crash", "kill", "hang"))
            if action in want:
                hits.append((action, arg))
            elif action == "delay":
                time.sleep(arg)
            elif action == "crash":
                raise InjectedCrash(
                    f"[faults:{self.name}] injected crash at frame {n}")
            elif action == "kill":
                print(f"[faults:{self.name}] SIGKILL at frame {n}",
                      flush=True)
                os.kill(os.getpid(), signal.SIGKILL)
            elif action == "hang":
                print(f"[faults:{self.name}] HANG at frame {n}", flush=True)
                deadline = (time.monotonic() + arg) if arg > 0 \
                    else float("inf")
                while time.monotonic() < deadline:
                    time.sleep(0.2)
        return hits

    @property
    def frames_seen(self) -> int:
        with self._lock:
            return self._n
