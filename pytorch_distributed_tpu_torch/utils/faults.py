"""Deterministic fault injection for the checkpoint plane — the port of the
part of pytorch_distributed_tpu/utils/faults.py (:107-230) that the
epoch writer consults: ``parse_faults`` and ``FaultInjector`` with
``from_env`` and ``frame``.

The epoch writer (utils/checkpoint.py ``save_epoch``) counts one frame
per write point of a save (``FRAMES_PER_SAVE`` a save), so a drill can
end the process at an exact boundary of an exact save.  The schedule
comes from the ``CKPT_FAULTS`` environment variable, which spawn
children inherit: ``kill@N`` SIGKILLs the process at frame N, as a host
that loses power would.  The reference's other actions and its wire,
feeder and learner planes are not ported.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Iterable, List, Tuple

FaultEvent = Tuple[int, str, float]  # (frame index, action, arg)

_ACTIONS = ("kill",)


def parse_faults(spec: str) -> List[FaultEvent]:
    """``"kill@5,kill@9"`` -> [(5, "kill", 0.0), (9, "kill", 0.0)].
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
    """One injector per instrumented plane.  ``frame()`` counts one
    operation and SIGKILLs the process at a scheduled index."""

    def __init__(self, events: Iterable[FaultEvent] = (), name: str = ""):
        self.name = name
        self._lock = threading.Lock()
        self._n = 0
        self._kill_at = {at for at, _action, _arg in events}

    @classmethod
    def from_env(cls, role: str) -> "FaultInjector":
        """The schedule in ``{ROLE}_FAULTS`` (``CKPT_FAULTS`` for the
        checkpoint writer); unset or empty: an injector that fires
        nothing."""
        spec = os.environ.get(f"{role.upper()}_FAULTS", "").strip()
        return cls(parse_faults(spec), name=role)

    def frame(self) -> None:
        """Account one operation; fire its scheduled event."""
        with self._lock:
            n = self._n
            self._n += 1
        if n in self._kill_at:
            print(f"[faults:{self.name}] SIGKILL at frame {n}", flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
