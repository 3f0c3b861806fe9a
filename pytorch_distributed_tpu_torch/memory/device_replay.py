"""Replay ring in device memory — the port of
pytorch_distributed_tpu/memory/device_replay.py: ``ReplayState`` and
``ring_write`` (:34-85), ``DeviceReplay`` (:265-388), and the queue front
end ``DeviceReplayIngest`` / ``drain`` (:389-611) without the flow-shed and
quarantine planes, plus ``DevicePerIngest`` (:614-638).  The ingest queue
is the reference's (memory/feeder.py ``QueueFeeder`` :30, ``QueueOwner``
:240): a spawn-context ``multiprocessing.Queue`` of transition chunks, so
feeders pickle to actor processes.  For the thread backend
(``in_process``) it is a ``queue.Queue`` with the same bound, where the
reference swaps one in before any worker starts (runtime.py
``_use_thread_queue`` :357-372).

The six transition columns live as tensors on the learner's device.  Where
the reference's functional ring returns a new state from every write, the
port writes in place (a copy into the ring's slice): at config 12's 50,000
rows the two uint8 frame columns hold 2 x 50,000 x 28,224 B (about
2.8 GB), and a copy per ingest would double that.  The write cursor and the fill count are host
integers: ingest is driven from the host, so the host always knows them.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch.utils.experience import (
    REPLAY_FIELDS, Transition,
)

_CTX = mp.get_context("spawn")


@dataclass
class ReplayState:
    state0: torch.Tensor     # (N, *state_shape)
    action: torch.Tensor     # (N, *action_shape)
    reward: torch.Tensor     # (N,) float32
    gamma_n: torch.Tensor    # (N,) float32
    state1: torch.Tensor     # (N, *state_shape)
    terminal1: torch.Tensor  # (N,) float32
    pos: int = 0             # write cursor
    fill: int = 0            # valid rows


def ring_write(state: ReplayState, chunk: Transition, capacity: int,
               non_blocking: bool = False) -> List[Tuple[int, int]]:
    """Write a chunk (host columns, numpy arrays or CPU tensors, ``n <=
    capacity`` rows) at the cursor, in place: one host-to-device copy per
    column into the ring's slice, or two where the chunk wraps, on the
    current stream.  ``non_blocking`` for pinned columns, which the caller
    must not overwrite before the copies are done.  Returns the written
    ``(start, stop)`` spans so extended schemas (the PER ring) can set
    their per-row fields at the same places."""
    n = int(np.shape(chunk.reward)[0])
    if not 0 < n <= capacity:
        raise ValueError(f"chunk of {n} rows for a ring of {capacity}")
    first = min(n, capacity - state.pos)
    spans = [(state.pos, state.pos + first)]
    if first < n:
        spans.append((0, n - first))
    for f in REPLAY_FIELDS:
        col = getattr(state, f)
        host = torch.as_tensor(getattr(chunk, f))
        col[spans[0][0]:spans[0][1]].copy_(host[:first],
                                           non_blocking=non_blocking)
        if first < n:
            col[:n - first].copy_(host[first:], non_blocking=non_blocking)
    state.pos = (state.pos + n) % capacity
    state.fill = min(state.fill + n, capacity)
    return spans


class DeviceReplay:
    """Owner of the ring tensors (learner side only)."""

    def __init__(self, capacity: int, state_shape: Tuple[int, ...],
                 action_shape: Tuple[int, ...] = (),
                 state_dtype=torch.uint8, action_dtype=torch.int32,
                 device="cpu"):
        self.capacity = capacity
        self.state_shape = tuple(state_shape)
        self.action_shape = tuple(action_shape)
        self.device = torch.device(device)
        z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=self.device)
        self.state = self._extend(dict(
            state0=z((capacity, *self.state_shape), state_dtype),
            action=z((capacity, *self.action_shape), action_dtype),
            reward=z((capacity,), torch.float32),
            gamma_n=z((capacity,), torch.float32),
            state1=z((capacity, *self.state_shape), state_dtype),
            terminal1=z((capacity,), torch.float32)))

    def _extend(self, columns: dict) -> ReplayState:
        return ReplayState(**columns)

    def feed_chunk(self, chunk: Transition,
                   non_blocking: bool = False) -> None:
        ring_write(self.state, chunk, self.capacity, non_blocking)


class StagedWriter:
    """The drain's host side (reference: the feed is an asynchronous
    program enqueued behind the queued updates, memory/device_replay.py
    :308).  Rows are stacked straight into one of ``slabs`` host slabs of
    ``rows`` rows each (pinned for a ring on a GPU) and written to the
    ring from there; a drain larger than a slab takes the slabs in turn.
    On a GPU the copies are non-blocking on the current stream, so they
    run in order after the update already queued there and before the
    next one, and an event recorded after a slab's copies is waited on
    before the slab is refilled: the only wait on the device in the
    drain.  Pinned memory stays at ``slabs * rows`` rows whatever the
    drain's size."""

    def __init__(self, replay: "DeviceReplay", rows: int, slabs: int):
        self.replay = replay
        self.rows = max(1, min(rows, replay.capacity))
        self.pinned = replay.device.type == "cuda"
        st = replay.state
        self._slabs = [{f: torch.empty((self.rows, *getattr(st, f).shape[1:]),
                                       dtype=getattr(st, f).dtype,
                                       pin_memory=self.pinned)
                        for f in REPLAY_FIELDS} for _ in range(slabs)]
        self._events: List[Optional[torch.cuda.Event]] = [None] * slabs
        self._next = 0

    def write(self, rows: List[Transition]) -> None:
        for lo in range(0, len(rows), self.rows):
            part = rows[lo:lo + self.rows]
            n, i = len(part), self._next
            self._next = (i + 1) % len(self._slabs)
            if self._events[i] is not None:
                self._events[i].synchronize()  # its last copies are done
            slab = self._slabs[i]
            for f in REPLAY_FIELDS:
                np.stack([getattr(r, f) for r in part],
                         out=slab[f].numpy()[:n])
            self.replay.feed_chunk(Transition(*(slab[f][:n]
                                                for f in REPLAY_FIELDS)),
                                   non_blocking=self.pinned)
            if self.pinned:
                self._events[i] = torch.cuda.Event()
                self._events[i].record()


class QueueFeeder:
    """Actor-side feed endpoint (reference memory/feeder.py QueueFeeder):
    buffers ``chunk`` transitions, then puts them on the ingest queue as
    one list.  A put blocked on a full queue gives up once the run's stop
    event is set."""

    def __init__(self, q, chunk: int = 16):
        self._q = q
        self._chunk = chunk
        self._buf: List[Transition] = []
        self._stop = None

    def clone(self) -> "QueueFeeder":
        """Same queue, own buffer: one per actor thread."""
        f = QueueFeeder(self._q, self._chunk)
        f._stop = self._stop
        return f

    def set_stop(self, event) -> None:
        self._stop = event

    def close(self) -> None:
        """Never block a process's exit on the queue's feeder thread: once
        the learner stops draining, its buffered chunks cannot flush into
        the full pipe (reference feeder.py:136-142)."""
        if hasattr(self._q, "cancel_join_thread"):  # mp queue only
            self._q.cancel_join_thread()

    def feed(self, transition: Transition) -> None:
        self._buf.append(transition)
        if len(self._buf) >= self._chunk:
            self.flush()

    def flush(self) -> None:
        if not self._buf:
            return
        while True:
            if self._stop is not None and self._stop.is_set():
                break  # shutdown: the learner no longer drains
            try:
                self._q.put(self._buf, timeout=0.2)
                break
            except queue.Full:
                continue
        self._buf = []


STAGE_ROWS = 512   # rows per staging slab: 29 MB of config 12's frames
STAGE_SLABS = 3


class DeviceReplayIngest:
    """Queue front end of the device ring: actors feed through
    ``make_feeder()``; the learner calls ``attach(device)`` and then
    ``drain()`` between dispatches, which stacks pending rows into the
    staging slabs (``StagedWriter``) and writes them with one
    host-to-device copy per column and slab."""

    def __init__(self, capacity: int, state_shape: Tuple[int, ...],
                 action_shape: Tuple[int, ...] = (),
                 state_dtype=np.uint8, action_dtype=np.int32,
                 max_queue_chunks: int = 4096, in_process: bool = False):
        self.capacity = capacity
        self.state_shape = tuple(state_shape)
        self.action_shape = tuple(action_shape)
        self.state_dtype = np.dtype(state_dtype)
        self.action_dtype = np.dtype(action_dtype)
        self.max_queue_chunks = max_queue_chunks  # backpressure bound
        # in-process producers (the thread backend) hand chunks over by
        # reference instead of pickling each one through a pipe
        self._q = (queue.Queue(max_queue_chunks) if in_process
                   else _CTX.Queue(max_queue_chunks))
        self.replay: Optional[DeviceReplay] = None
        self._staging: Optional[StagedWriter] = None
        self._pending: List[Transition] = []
        self._fed_total = 0

    def make_feeder(self, chunk: int = 16) -> QueueFeeder:
        return QueueFeeder(self._q, chunk)

    def close_write_end(self) -> None:
        """Drop this process's end for writing, once every producer holds
        its own (the learner's process never puts).  A producer that dies
        while writing a chunk leaves a partial message in the pipe, which
        a read would wait on forever; with this end closed the read ends
        in ``EOFError`` once the other producers have exited too."""
        if hasattr(self._q, "_writer"):  # mp queue only
            self._q._writer.close()

    def close(self) -> None:
        """Shut the queue down; pending chunks are dropped (reference
        feeder.py:339-349)."""
        if hasattr(self._q, "cancel_join_thread"):  # mp queue only
            self._q.cancel_join_thread()
            self._q.close()

    def _ring_kwargs(self, device) -> dict:
        return dict(capacity=self.capacity, state_shape=self.state_shape,
                    action_shape=self.action_shape,
                    state_dtype=_torch_dtype(self.state_dtype),
                    action_dtype=_torch_dtype(self.action_dtype),
                    device=device)

    def _make_replay(self, device) -> DeviceReplay:
        return DeviceReplay(**self._ring_kwargs(device))

    def attach(self, device) -> DeviceReplay:
        """Allocate the ring on the learner's device, and its staging."""
        self.replay = self._make_replay(device)
        self._staging = StagedWriter(self.replay, STAGE_ROWS, STAGE_SLABS)
        return self.replay

    @property
    def size(self) -> int:
        if self.replay is None:
            raise RuntimeError("attach() first")
        return min(self._fed_total, self.replay.capacity)

    def drain(self, max_chunks: int = 1024, max_rows: int = 32768) -> int:
        """Move queued transitions into the ring, at most ``max_rows`` per
        call (the rest stays pending for the next drain).  Returns rows
        written."""
        if self.replay is None:
            raise RuntimeError("attach() first")
        if not self._pending and self._q.empty():
            return 0
        for _ in range(max_chunks):
            try:
                self._pending.extend(self._q.get_nowait())
            except queue.Empty:
                break
            except (EOFError, OSError) as e:
                raise RuntimeError("the ingest queue broke off inside a "
                                   "chunk: a producer died while writing "
                                   "it") from e
        n = min(len(self._pending), max_rows)
        rows, self._pending = self._pending[:n], self._pending[n:]
        if n:
            self._staging.write(rows)
        self._fed_total += n
        return n


class DevicePerIngest(DeviceReplayIngest):
    """Queue front end of the prioritized device ring (memory/device_per.py):
    new rows enter at the running max priority; priorities live and update
    on the device only."""

    def __init__(self, *args, priority_exponent: float = 0.6,
                 importance_weight: float = 0.4,
                 importance_anneal_steps: int = 500000, **kw):
        super().__init__(*args, **kw)
        self.priority_exponent = priority_exponent
        self.importance_weight = importance_weight
        self.importance_anneal_steps = importance_anneal_steps

    def _make_replay(self, device):
        from pytorch_distributed_tpu_torch.memory.device_per import (
            DevicePerReplay,
        )

        return DevicePerReplay(
            priority_exponent=self.priority_exponent,
            importance_weight=self.importance_weight,
            importance_anneal_steps=self.importance_anneal_steps,
            **self._ring_kwargs(device))


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=dt)).dtype
