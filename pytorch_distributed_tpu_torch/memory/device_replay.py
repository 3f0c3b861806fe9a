"""Replay ring in device memory — the port of
pytorch_distributed_tpu/memory/device_replay.py: ``ReplayState`` and
``ring_write`` (:34-85), ``DeviceReplay`` (:265-388), and the queue front
end ``DeviceReplayIngest`` / ``drain`` (:389-611) with its quarantine
boundary and without the flow-shed plane, plus ``DevicePerIngest``
(:614-638), and the rings' checkpoint surface (``snapshot``/``restore``,
:343-377, :517-542). The feed is the reference's (memory/feeder.py
``QueueFeeder`` :30): chunks of transitions put on a spawn-context
``multiprocessing.Queue``. Where the reference shares one queue among
every actor, the port gives each actor slot a queue of its own
(``make_feeder(slot)``), so every pipe has one writer: an actor killed
inside a put tears only its own queue, and its respawn is handed a fresh
one (``replace_slot``) while the old one is read to its end. The total
bound of queued chunks is split over the slots. For the thread backend
(``in_process``) one ``queue.Queue`` with the whole bound serves every
slot, where the reference swaps one in before any worker starts
(runtime.py ``_use_thread_queue`` :357-372).

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
import threading
import time
from dataclasses import dataclass
from multiprocessing import connection
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch.utils import health
from pytorch_distributed_tpu_torch.utils.experience import (
    REPLAY_FIELDS, Transition,
)
from pytorch_distributed_tpu_torch.utils.faults import FaultInjector

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
    # the write cursor on the device, for writes inside a CUDA graph
    # (``ring_write_masked``); set from ``pos`` before each such dispatch
    cursor: Optional[torch.Tensor] = None


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


def masked_write_index(state: ReplayState, valid: torch.Tensor,
                       capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ring rows for a chunk's rows under ``valid`` (reference
    memory/device_replay.py:92-125): valid row i goes to ``cursor +
    rank_i``; the invalid rows go, in turn, to the rows after the last
    valid one (distinct from every valid row, ``n <= capacity``), where
    the writer puts back what they hold.  Returns ``(idx, total)``, both on
    the device: no host sync, so a CUDA graph can capture it."""
    v = valid.to(torch.int64)
    total = v.sum()
    rank = torch.cumsum(v, 0) - 1
    rank_off = torch.cumsum(1 - v, 0) - 1 + total
    idx = (state.cursor + torch.where(valid, rank, rank_off)) % capacity
    return idx, total


def _masked_put(col: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
                new: torch.Tensor) -> None:
    keep = valid.reshape(valid.shape + (1,) * (new.dim() - 1))
    col.index_copy_(0, idx, torch.where(keep, new.to(col.dtype),
                                        col.index_select(0, idx)))


def ring_write_masked(state: ReplayState, chunk: Transition,
                      valid: torch.Tensor, capacity: int) -> torch.Tensor:
    """Write only the ``valid`` rows of a device chunk at the device
    cursor, in chunk order, in place: invalid rows take no slot and
    change no row, and the cursor moves by the valid count.  The fused
    rollout's replay emit writes with it (warmup ticks have no closed
    n-step window).  Returns the count written, on the device; the host's
    ``pos``/``fill`` are the caller's to advance (the count is a pure
    function of the tick window)."""
    idx, total = masked_write_index(state, valid, capacity)
    for f in REPLAY_FIELDS:
        _masked_put(getattr(state, f), idx, valid, getattr(chunk, f))
    state.cursor.copy_((state.cursor + total) % capacity)
    return total


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
            terminal1=z((capacity,), torch.float32),
            cursor=z((), torch.int64)))

    def _extend(self, columns: dict) -> ReplayState:
        return ReplayState(**columns)

    def feed_chunk(self, chunk: Transition,
                   non_blocking: bool = False) -> None:
        ring_write(self.state, chunk, self.capacity, non_blocking)

    def _age_order(self, col: torch.Tensor) -> np.ndarray:
        """The valid rows of a column, oldest first, on the host: when the
        ring is full the cursor points at the oldest row; before that,
        ``[0, fill)`` is oldest first."""
        st = self.state
        if st.fill == self.capacity and st.pos:
            col = torch.cat([col[st.pos:], col[:st.pos]])
        else:
            col = col[:st.fill]
        return col.cpu().numpy().copy()

    def snapshot(self) -> dict:
        """The valid rows, oldest first, as host arrays in NCHW (the
        reference's snapshot without its provenance column)."""
        return {f: self._age_order(getattr(self.state, f))
                for f in REPLAY_FIELDS}

    def _reset(self) -> None:
        """Empty the ring in place: the tensors stay the ones a captured
        graph reads."""
        st = self.state
        for f in REPLAY_FIELDS:
            getattr(st, f).zero_()
        st.cursor.zero_()
        st.pos = st.fill = 0

    def restore(self, data: dict) -> int:
        """Replace the contents with a snapshot's newest rows that fit,
        written through the normal ring write.  Returns rows restored.  A
        ``prov`` column, which the reference's snapshots carry, is
        ignored."""
        self._reset()
        n = min(len(np.asarray(data["reward"])), self.capacity)
        if n:
            self.feed_chunk(Transition(*(np.asarray(data[f])[-n:]
                                         for f in REPLAY_FIELDS)))
        return n


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
    event is set.  Each flush is one frame of the ``FEEDER_FAULTS`` plane
    (utils/faults.py), whose ``poison_chunk@N`` NaNs the rewards of flush
    N's rows (``health.poison_items``), as reference feeder.py:149-160
    does; the injector is built in the process that flushes."""

    def __init__(self, q, chunk: int = 16):
        self._q = q
        self._chunk = chunk
        self._buf: List[Transition] = []
        self._stop = None
        self._faults: Optional[FaultInjector] = None

    def __getstate__(self):
        # the injector holds a lock; a spawn child builds its own from the
        # FEEDER_FAULTS it inherits
        d = self.__dict__.copy()
        d["_faults"] = None
        return d

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
        if self._faults is None:
            self._faults = FaultInjector.from_env("feeder")
        if self._faults.data_frame(("poison_chunk",)):
            self._buf = [t for t, _p in health.poison_items(
                [(t, None) for t in self._buf])]
            print("[faults:feeder] poison_chunk: chunk poisoned before "
                  "flush", flush=True)
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
    """Queue front end of the device ring: actor slot ``i`` feeds through
    ``make_feeder(i)``; the learner calls ``attach(device)`` and then
    ``drain()`` between dispatches, which reads every slot's queue,
    stacks the rows into the staging slabs (``StagedWriter``) and writes
    them with one host-to-device copy per column and slab.

    On the process backend the topology closes its own write end of a
    slot's queue right after the spawn that hands it over
    (``close_write_end``) and names the child's sentinel
    (``bind_producer``).  A read that ends in ``EOFError`` or ``OSError``
    then means that every writer is gone: if the queue's producer has
    exited (or the queue was replaced), what was left is dropped, the
    read is counted in ``torn_reads`` and the queue is closed; if the
    producer is still alive the drain raises.

    The drain is also the ingest's quarantine boundary (reference
    :561-581): with ``quarantine`` on and ``TPU_APEX_QUARANTINE`` not 0,
    a ``health.ChunkValidator`` (built on the first drain, against the
    ring's state shape and dtype) checks every row read, and the rows it
    rejects go to ``health.get_quarantine("feeder-device")``, which
    writes ``{log_dir}/quarantine/``, instead of the ring.  ``validated``,
    ``quarantined`` and ``validate_s`` count the rows checked, the rows
    diverted and the host seconds the checks took."""

    def __init__(self, capacity: int, state_shape: Tuple[int, ...],
                 action_shape: Tuple[int, ...] = (),
                 state_dtype=np.uint8, action_dtype=np.int32,
                 max_queue_chunks: int = 4096, in_process: bool = False,
                 slots: int = 1, quarantine: bool = True,
                 quarantine_max_files: int = 64):
        self.capacity = capacity
        self.state_shape = tuple(state_shape)
        self.action_shape = tuple(action_shape)
        self.state_dtype = np.dtype(state_dtype)
        self.action_dtype = np.dtype(action_dtype)
        self.max_queue_chunks = max_queue_chunks  # backpressure bound
        # in-process producers (the thread backend) hand chunks over by
        # reference through one queue instead of pickling through pipes
        self._shared = queue.Queue(max_queue_chunks) if in_process else None
        self._slot_bound = max(1, max_queue_chunks // max(1, slots))
        self._lock = threading.Lock()  # the drain vs the runtime's monitor
        self._live: Dict[int, object] = {}     # slot -> its queue
        self._retiring: List[object] = []      # replaced, read to the end
        self._producer: Dict[int, object] = {}  # id(queue) -> sentinel
        self.torn_reads = 0
        self.replay: Optional[DeviceReplay] = None
        self.replay_b: Optional[DeviceReplay] = None
        self._staging: Optional[StagedWriter] = None
        self._pending: List[Transition] = []
        self._fed_total = 0
        self.quarantine = quarantine
        self.quarantine_max_files = quarantine_max_files
        self._validator: Optional[health.ChunkValidator] = None
        self.validated = self.quarantined = 0
        self.validate_s = 0.0

    def _slot_queue(self, slot: int):
        with self._lock:
            if slot not in self._live:
                self._live[slot] = _CTX.Queue(self._slot_bound)
            return self._live[slot]

    def make_feeder(self, slot: int = 0, chunk: int = 16) -> QueueFeeder:
        """The feeder of actor slot ``slot``."""
        if self._shared is not None:
            return QueueFeeder(self._shared, chunk)
        return QueueFeeder(self._slot_queue(slot), chunk)

    def replace_slot(self, slot: int, chunk: int = 16) -> QueueFeeder:
        """A fresh queue for the respawn of ``slot`` and its feeder; the
        old queue is read to its end by the following drains."""
        if self._shared is not None:
            raise RuntimeError("the in-process queue has no slots")
        with self._lock:
            old = self._live.pop(slot, None)
            if old is not None:
                self._retiring.append(old)
        return self.make_feeder(slot, chunk)

    def bind_producer(self, slot: int, sentinel) -> None:
        """Name the process that writes ``slot``'s queue, by its
        ``Process.sentinel``."""
        self._producer[id(self._slot_queue(slot))] = sentinel

    def close_write_end(self, slot: int) -> None:
        """Drop this process's write end of ``slot``'s queue once its
        producer holds its own: this process never puts.  A producer that
        dies inside a put leaves a partial message in its pipe, which a
        read would wait on forever; with this end closed the read ends in
        ``EOFError`` instead."""
        self._slot_queue(slot)._writer.close()

    def _sources(self) -> list:
        """(slot or None, queue) of every queue to read: the live slots'
        and the replaced ones'."""
        if self._shared is not None:
            return [(0, self._shared)]
        with self._lock:
            return list(self._live.items()) + [(None, q)
                                               for q in self._retiring]

    def _producer_gone(self, slot, q, timeout: float = 5.0) -> bool:
        if slot is None:
            return True  # replaced: its producer is dead
        sentinel = self._producer.get(id(q))
        return sentinel is not None and bool(
            connection.wait([sentinel], timeout))

    def _retire(self, q) -> None:
        with self._lock:
            if q in self._retiring:
                self._retiring.remove(q)
            for slot, live in list(self._live.items()):
                if live is q:
                    del self._live[slot]
            self._producer.pop(id(q), None)
        _close_queue(q)

    def close(self) -> None:
        """Shut every queue down; pending chunks are dropped (reference
        feeder.py:339-349)."""
        if self._shared is not None:
            return
        with self._lock:
            qs = list(self._live.values()) + self._retiring
            self._live, self._retiring = {}, []
        for q in qs:
            _close_queue(q)

    def _ring_kwargs(self, device, capacity: Optional[int] = None) -> dict:
        return dict(capacity=capacity or self.capacity,
                    state_shape=self.state_shape,
                    action_shape=self.action_shape,
                    state_dtype=_torch_dtype(self.state_dtype),
                    action_dtype=_torch_dtype(self.action_dtype),
                    device=device)

    def _make_replay(self, device, capacity: Optional[int] = None
                     ) -> DeviceReplay:
        return DeviceReplay(**self._ring_kwargs(device, capacity))

    def attach(self, device) -> DeviceReplay:
        """Allocate the ring on the learner's device, and its staging."""
        self.replay = self._make_replay(device)
        self._staging = StagedWriter(self.replay, STAGE_ROWS, STAGE_SLABS)
        return self.replay

    def attach_halves(self, device) -> Tuple[DeviceReplay, DeviceReplay]:
        """Two half-capacity rings for the Anakin loop's double buffer
        (reference :480-497): learner dispatches sample one while rollouts
        write the other.  The first is also ``self.replay``, so the drain
        and the checkpoint keep working on it."""
        half = max(self.capacity // 2, 1)
        self.replay = self._make_replay(device, half)
        self._staging = StagedWriter(self.replay, STAGE_ROWS, STAGE_SLABS)
        self.replay_b = self._make_replay(device, half)
        return self.replay, self.replay_b

    def note_scatter(self, rows: int) -> None:
        """Count rows written into the attached ring(s) inside a device
        program (the Anakin rollout's replay emit), which never pass
        ``drain`` (reference :499)."""
        self._fed_total += int(rows)

    @property
    def size(self) -> int:
        if self.replay is None:
            raise RuntimeError("attach() first")
        cap = self.replay.capacity * (2 if self.replay_b is not None
                                      else 1)
        return min(self._fed_total, cap)

    def drain(self, max_chunks: int = 1024, max_rows: int = 32768) -> int:
        """Move queued transitions into the ring: at most ``max_chunks``
        chunks read over all queues and ``max_rows`` rows written per
        call (the rest stays pending for the next drain).  Returns rows
        written."""
        if self.replay is None:
            raise RuntimeError("attach() first")
        budget = max_chunks
        fresh: List[Transition] = []
        for slot, q in self._sources():
            while budget > 0:
                try:
                    fresh.extend(q.get_nowait())
                    budget -= 1
                except queue.Empty:
                    if slot is None:  # a replaced queue, read to its end
                        self._retire(q)
                    break
                except (EOFError, OSError) as e:
                    if not self._producer_gone(slot, q):
                        raise RuntimeError(
                            "the ingest queue broke off inside a chunk: "
                            "its producer is alive") from e
                    self.torn_reads += 1
                    self._retire(q)
                    break
        if fresh and self.quarantine and health.quarantine_active():
            fresh = self._validate(fresh)
        self._pending.extend(fresh)
        n = min(len(self._pending), max_rows)
        rows, self._pending = self._pending[:n], self._pending[n:]
        if n:
            self._staging.write(rows)
        self._fed_total += n
        return n

    def _validate(self, rows: List[Transition]) -> List[Transition]:
        """The rows the validator passes; the others are quarantined."""
        t0 = time.perf_counter()
        if self._validator is None:
            self._validator = health.ChunkValidator(
                state_shape=self.state_shape, state_dtype=self.state_dtype)
        good, bad = self._validator.filter([(t, None) for t in rows])
        if bad:
            health.get_quarantine(
                "feeder-device", max_files=self.quarantine_max_files).put(bad)
            rows = [t for t, _p in good]
            self.quarantined += len(bad)
        self.validated += len(good) + len(bad)
        self.validate_s += time.perf_counter() - t0
        return rows

    def snapshot(self) -> dict:
        """Drain every queued chunk into the ring, then its snapshot."""
        if self.replay is None:
            raise RuntimeError("attach() first")
        while self.drain():  # a deep backlog takes several capped drains
            pass
        return self.replay.snapshot()

    def restore(self, data: dict) -> int:
        """Replace the ring's contents with a snapshot's; returns rows."""
        if self.replay is None:
            raise RuntimeError("attach() first")
        n = self.replay.restore(data)
        self._fed_total = n  # the ring was emptied first
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

    def _make_replay(self, device, capacity: Optional[int] = None):
        from pytorch_distributed_tpu_torch.memory.device_per import (
            DevicePerReplay,
        )

        return DevicePerReplay(
            priority_exponent=self.priority_exponent,
            importance_weight=self.importance_weight,
            importance_anneal_steps=self.importance_anneal_steps,
            **self._ring_kwargs(device, capacity))


def _close_queue(q) -> None:
    """Close a spawn queue in this process without waiting on a feeder
    thread.  ``close`` leaves the read end to the feeder thread, which
    closes both ends; with no thread (this process never put) the read
    end is closed here."""
    q.cancel_join_thread()
    q.close()
    if q._thread is None:
        q._reader.close()


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=dt)).dtype
