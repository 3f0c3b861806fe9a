"""Queue transport from the actors to the one process that owns a ring —
the port of pytorch_distributed_tpu/memory/feeder.py: ``QueueFeeder``
(:30-200), ``pop_chunks`` (:215-238) and ``QueueOwner`` (:240-349), with
the drain's quarantine (:262-292) through ``utils/health.py``.  The flow
shed policy and the trace spans wait for their planes (ROADMAP.md).

Where the reference shares one queue among every actor, the port gives
each actor slot a queue of its own (``SlotQueues.make_feeder(slot)``), so
every pipe has one writer: an actor killed inside a put tears only its
own queue, and its respawn is handed a fresh one (``replace_slot``) while
the old one is read to its end.  The total bound of queued chunks is
split over the slots.  For the thread backend (``in_process``) one
``queue.Queue`` with the whole bound serves every slot, where the
reference swaps one in before any worker starts (runtime.py
``_use_thread_queue`` :357-372).  ``SlotQueues`` is the transport of both
owners: ``QueueOwner`` (a host ring, the prioritized one) and
memory/device_replay.py ``DeviceReplayIngest`` (the device rings).
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import threading
import time
from multiprocessing import connection
from typing import Dict, List, Optional, Tuple

import numpy as np

from pytorch_distributed_tpu_torch.utils import health
from pytorch_distributed_tpu_torch.utils.experience import Transition
from pytorch_distributed_tpu_torch.utils.faults import FaultInjector

_CTX = mp.get_context("spawn")


class QueueFeeder:
    """Actor-side feed endpoint (reference :30): buffers ``chunk``
    transitions, then puts them on the ingest queue as one list.  A put
    blocked on a full queue gives up once the run's stop event is set.
    Each flush is one frame of the ``FEEDER_FAULTS`` plane
    (utils/faults.py), whose ``poison_chunk@N`` NaNs the rewards of flush
    N's rows (``health.poison_items``), as reference :149-160 does; the
    injector is built in the process that flushes."""

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
        the full pipe (reference :136-142)."""
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


def pop_chunks(q, out: List[Transition], max_chunks: int = 1024
               ) -> Tuple[int, bool]:
    """Read up to ``max_chunks`` chunks from one feeder queue into ``out``
    (reference :215-238).  Returns ``(chunks read, whether the queue ran
    empty)``.  An ``EOFError`` or ``OSError`` of a torn queue propagates,
    with the rows read before it already in ``out``."""
    for n in range(max_chunks):
        try:
            out.extend(q.get_nowait())
        except queue.Empty:
            return n, True
    return max_chunks, False


class SlotQueues:
    """The learner-side end of the actors' queues: actor slot ``i`` feeds
    through ``make_feeder(i)``, and ``read`` takes what every slot's queue
    holds and passes it through the ingest's quarantine.

    On the process backend the topology closes its own write end of a
    slot's queue right after the spawn that hands it over
    (``close_write_end``) and names the child's sentinel
    (``bind_producer``).  A read that ends in ``EOFError`` or ``OSError``
    then means that every writer is gone: if the queue's producer has
    exited (or the queue was replaced), what was left is dropped, the
    read is counted in ``torn_reads`` and the queue is closed; if the
    producer is still alive the read raises.

    The quarantine (reference :262-292): with ``quarantine`` on and
    ``TPU_APEX_QUARANTINE`` not 0, a ``health.ChunkValidator`` (built on
    the first read, against ``state_shape`` and ``state_dtype``) checks
    every row read, and the rows it rejects go to
    ``health.get_quarantine(source)``, which writes
    ``{log_dir}/quarantine/``.  ``validated``, ``quarantined`` and
    ``validate_s`` count the rows checked, the rows diverted and the host
    seconds the checks took."""

    source = "feeder-local"

    def __init__(self, state_shape: Tuple[int, ...], state_dtype,
                 max_queue_chunks: int = 4096, in_process: bool = False,
                 slots: int = 1, quarantine: bool = True,
                 quarantine_max_files: int = 64):
        self.state_shape = tuple(state_shape)
        self.state_dtype = np.dtype(state_dtype)
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
        old queue is read to its end by the following reads."""
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
        :339-349)."""
        if self._shared is not None:
            return
        with self._lock:
            qs = list(self._live.values()) + self._retiring
            self._live, self._retiring = {}, []
        for q in qs:
            _close_queue(q)

    def read(self, max_chunks: int = 1024) -> Tuple[List[Transition], int]:
        """The rows of at most ``max_chunks`` chunks over every queue, the
        quarantined ones taken out; returns ``(rows, rows popped)``."""
        budget = max_chunks
        fresh: List[Transition] = []
        for slot, q in self._sources():
            if budget <= 0:
                break
            try:
                n, empty = pop_chunks(q, fresh, budget)
                budget -= n
                if empty and slot is None:  # a replaced queue, read out
                    self._retire(q)
            except (EOFError, OSError) as e:
                if not self._producer_gone(slot, q):
                    raise RuntimeError(
                        "the ingest queue broke off inside a chunk: its "
                        "producer is alive") from e
                self.torn_reads += 1
                self._retire(q)
        popped = len(fresh)
        if fresh and self.quarantine and health.quarantine_active():
            fresh = self._validate(fresh)
        return fresh, popped

    def _validate(self, rows: List[Transition]) -> List[Transition]:
        """The rows the validator passes; the others are quarantined."""
        t0 = time.perf_counter()
        if self._validator is None:
            self._validator = health.ChunkValidator(
                state_shape=self.state_shape, state_dtype=self.state_dtype)
        good, bad = self._validator.filter([(t, None) for t in rows])
        if bad:
            health.get_quarantine(
                self.source, max_files=self.quarantine_max_files).put(bad)
            rows = [t for t, _p in good]
            self.quarantined += len(bad)
        self.validated += len(good) + len(bad)
        self.validate_s += time.perf_counter() - t0
        return rows


class QueueOwner(SlotQueues):
    """The learner-side owner of a host ring that actors reach through
    queues (reference :240-349): ``drain`` moves what the queues hold into
    ``memory`` (after the quarantine), and the sampling, priority and
    checkpoint surface is the memory's.  Only the learner drains."""

    def __init__(self, memory, **kw):
        super().__init__(memory.state_shape, memory.state_dtype, **kw)
        self.memory = memory

    def drain(self, max_chunks: int = 1024) -> int:
        """Pull pending chunks into the memory; returns the rows popped
        from the queues (fed and quarantined), so a drain-to-empty loop
        does not read an all-quarantined batch as a dry queue."""
        rows, popped = self.read(max_chunks)
        for t in rows:
            self.memory.feed(t)
        return popped

    def snapshot(self) -> dict:
        while self.drain():  # a deep backlog takes several capped drains
            pass
        return self.memory.snapshot()

    def restore(self, data: dict) -> int:
        return self.memory.restore(data)

    @property
    def size(self) -> int:
        return self.memory.size

    @property
    def capacity(self) -> int:
        return self.memory.capacity

    def sample(self, batch_size: int, rng: np.random.Generator):
        return self.memory.sample(batch_size, rng)

    def update_priorities(self, indices: np.ndarray,
                          priorities: np.ndarray) -> None:
        self.memory.update_priorities(indices, priorities)

    @property
    def prioritized(self) -> bool:
        return self.memory.prioritized

    def xray(self) -> Optional[dict]:
        return self.memory.xray()


def _close_queue(q) -> None:
    """Close a spawn queue in this process without waiting on a feeder
    thread.  ``close`` leaves the read end to the feeder thread, which
    closes both ends; with no thread (this process never put) the read
    end is closed here."""
    q.cancel_join_thread()
    q.close()
    if q._thread is None:
        q._reader.close()
