"""Deterministic fault injection — the port of
pytorch_distributed_tpu/utils/faults.py (:78-305): ``parse_faults`` and
``FaultInjector`` with ``scripted``, ``random`` (its ``_RANDOM_RATES``,
:78-84, :157-175), ``from_env``, ``frame``, ``data_frame`` and the
flight-recorder note (``_note``).

An instrumented endpoint counts one frame per operation, and an event
scheduled at that frame fires.  The schedule comes from
``{ROLE}_FAULTS`` in the environment, which spawn children inherit:

- ``CKPT_FAULTS``: the epoch writer (utils/checkpoint.py ``save_epoch``),
  one frame per write point of a save;
- ``FEEDER_FAULTS``: an actor's ingest feeder, one frame per flush
  (memory/feeder.py ``QueueFeeder.flush``);
- ``LEARNER_FAULTS``: the learner, one frame per update dispatch;
- ``ACTOR_FAULTS``: an actor, one frame per vector tick (one per fused
  dispatch on the device backend);
- ``REPLICA_FAULTS``: a learner replica, one frame per round
  (agents/learner.py ``ReplicaLearnerDriver.run_rounds``; ``kill@N`` is
  the replica host's SIGKILL at round N);
- ``DCN_FAULTS_CLIENT`` and ``DCN_FAULTS_GATEWAY``: the wire
  (parallel/dcn.py).  A ``DcnClient`` counts the frames it sends (HELLO
  is frame 0), a ``DcnGateway`` the frames it receives over every
  connection; ``fleet --faults-client`` / ``--faults-gateway`` set them.

Each variable holds a scripted spec or ``random:SEED[:HORIZON]``: a
schedule drawn with numpy from the seed over the first HORIZON (4000)
frames, in the reference's order, so one seed gives both packages the
same events.

Actions (``action@frame`` or ``action@frame:arg``):

- ``sever@N``: raise ``InjectedDisconnect`` (a ``ConnectionError``) at
  frame N: the connection dies and the client's reconnect path recovers;
- ``blackhole@N:S``: stall S seconds, then sever (a partition that
  heals);
- ``corrupt@N``: flip the first and the middle byte of frame N's payload
  (the peer must drop the frame, never decode it);
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
nothing runs after a SIGKILL.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from pytorch_distributed_tpu_torch.utils import flight_recorder

FaultEvent = Tuple[int, str, float]  # (frame index, action, arg)

_ACTIONS = ("sever", "delay", "blackhole", "corrupt", "crash", "kill",
            "poison_chunk", "poison_grad", "hang")

# the random mode's per-frame probabilities, drawn in this order
_RANDOM_RATES = {"sever": 0.002, "delay": 0.003, "corrupt": 0.001}
_RANDOM_DELAY_S = 0.05


class InjectedDisconnect(ConnectionError):
    """A fault-injected connection death, handled as a real socket error
    by the session layer."""


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
    def scripted(cls, spec: str, name: str = "") -> "FaultInjector":
        return cls(parse_faults(spec), name=name)

    @classmethod
    def random(cls, seed: int, horizon: int = 4000,
               rates: Optional[Dict[str, float]] = None,
               name: str = "") -> "FaultInjector":
        """A reproducible schedule over the first ``horizon`` frames: one
        ``rng.random(horizon)`` draw per action, in the rates' order.
        ``crash`` is never drawn: the wire injector only breaks the
        wire."""
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        for action, p in (rates if rates is not None
                          else _RANDOM_RATES).items():
            hits = np.nonzero(rng.random(horizon) < p)[0]
            arg = _RANDOM_DELAY_S if action in ("delay", "blackhole") else 0.0
            events.extend((int(at), action, arg) for at in hits)
        return cls(events, name=name)

    @classmethod
    def from_env(cls, role: str) -> "FaultInjector":
        """The schedule in ``DCN_FAULTS_CLIENT`` / ``DCN_FAULTS_GATEWAY``
        (roles ``client`` and ``gateway``) or ``{ROLE}_FAULTS``: a
        scripted spec or ``random:SEED[:HORIZON]``; unset or empty: an
        injector that fires nothing."""
        var = (f"DCN_FAULTS_{role.upper()}" if role in ("client", "gateway")
               else f"{role.upper()}_FAULTS")
        spec = os.environ.get(var, "").strip()
        if spec.startswith("random:"):
            parts = spec.split(":")
            horizon = int(parts[2]) if len(parts) > 2 else 4000
            return cls.random(int(parts[1]), horizon=horizon, name=role)
        return cls(parse_faults(spec), name=role)

    def _note(self, action: str, frame: int, fatal: bool) -> None:
        """Record the event in the flight recorder; a fatal one also dumps
        every ring of this process now."""
        flight_recorder.get_recorder(f"faults-{self.name or 'anon'}").record(
            "fault", action=action, frame=frame)
        if fatal:
            flight_recorder.dump_all(f"injected {action} at frame {frame} "
                                     f"(faults:{self.name})")

    def frame(self, payload: bytes = b"") -> bytes:
        """Account one operation; fire its scheduled events.  Returns the
        payload, corrupted under ``corrupt``."""
        payload, _ = self._step(payload, ())
        return payload

    def data_frame(self, want: Tuple[str, ...] = ()
                   ) -> List[Tuple[str, float]]:
        """Account one data-plane operation (a feeder flush, a learner
        dispatch, an actor tick): fire the events scheduled at it as
        ``frame`` does, and return the fired ones named in ``want``, which
        the caller applies itself."""
        _, hits = self._step(b"", tuple(want))
        return hits

    def _step(self, payload: bytes, want: Tuple[str, ...]
              ) -> Tuple[bytes, List[Tuple[str, float]]]:
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
            elif action == "sever":
                raise InjectedDisconnect(
                    f"[faults:{self.name}] injected sever at frame {n}")
            elif action == "blackhole":
                time.sleep(arg)
                raise InjectedDisconnect(
                    f"[faults:{self.name}] blackhole healed after {arg}s "
                    f"at frame {n}")
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
            elif action == "corrupt":
                if payload:
                    # the leading byte (the zip magic) and a middle one: a
                    # middle flip alone can land in member padding
                    mutated = bytearray(payload)
                    for i in {0, len(mutated) // 2}:
                        mutated[i] ^= 0xFF
                    payload = bytes(mutated)
                else:
                    payload = b"\xff"
        return payload, hits

    @property
    def frames_seen(self) -> int:
        with self._lock:
            return self._n
