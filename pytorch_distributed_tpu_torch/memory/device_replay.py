"""Replay ring in device memory — the port of
pytorch_distributed_tpu/memory/device_replay.py: ``ReplayState`` and
``ring_write`` (:34-85), ``sample_rows`` (:174-188),
``build_uniform_fused_step`` (:202-260) with its sequential and megabatch
arms, ``DeviceReplay`` (:265-388), and the queue front end
``DeviceReplayIngest`` / ``drain`` (:389-611) with its quarantine boundary
and without the flow-shed plane, plus ``DevicePerIngest`` (:614-638), and
the rings' checkpoint surface (``snapshot``/``restore``, :343-377,
:517-542).  The feed is memory/feeder.py's: each actor slot puts chunks
of transitions on a queue of its own (``SlotQueues``).

The six transition columns live as tensors on the learner's device.  Where
the reference's functional ring returns a new state from every write, the
port writes in place (a copy into the ring's slice): at config 12's 50,000
rows the two uint8 frame columns hold 2 x 50,000 x 28,224 B (about
2.8 GB), and a copy per ingest would double that.  The write cursor and the fill count are host
integers: ingest is driven from the host, so the host always knows them.
Their device copies (``cursor``, ``fill_rows``) serve the programs that
run from a CUDA graph: the masked writes of the fused rollout and the
uniform draw, which reads the fill.

The uniform draw takes uniforms, as the PER draw does, so the fused steps
of both rings take one (K, B) tensor of uniforms from the learner's
generator: ``uniform_index`` turns ``u`` into ``min(floor(u * fill),
fill - 1)`` (the reference draws ``randint(key, (B,), 0, max(fill, 1))``),
and ``sample_rows`` gathers the rows at given indices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch.memory.feeder import SlotQueues
from pytorch_distributed_tpu_torch.ops.losses import SKIPPED_KEY
from pytorch_distributed_tpu_torch.utils.experience import (
    REPLAY_FIELDS, Batch, Transition,
)


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
    # () f32 copy of ``fill`` on the device: the uniform draw and the IS
    # weights read it, and the masked writes move it on the device
    fill_rows: Optional[torch.Tensor] = None


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
    state.fill_rows.fill_(float(state.fill))
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
    state.fill_rows.copy_(torch.clamp(state.fill_rows + total,
                                      max=float(capacity)))
    return total


def uniform_index(state: ReplayState, u: torch.Tensor) -> torch.Tensor:
    """Uniform row indices ``min(floor(u * fill), fill - 1)`` over the
    ring's valid rows, from uniforms ``u`` in [0, 1) and the device fill
    (at least 1): the draw of the reference's ``sample_rows``, on the
    device, so a CUDA graph can capture it."""
    fill = torch.clamp(state.fill_rows, min=1.0)
    return torch.minimum(torch.floor(u * fill), fill - 1).long()


def sample_rows(state: ReplayState, idx: torch.Tensor) -> Batch:
    """The rows at ``idx`` as a uniform batch: IS weights 1 (reference
    :174-188, given the draw's indices)."""
    return Batch(
        state0=state.state0[idx], action=state.action[idx],
        reward=state.reward[idx], gamma_n=state.gamma_n[idx],
        state1=state.state1[idx], terminal1=state.terminal1[idx],
        weight=torch.ones(idx.shape, dtype=torch.float32,
                          device=idx.device),
        index=idx)


def group_batches(batch: Batch, m: int) -> Batch:
    """A batch of M*B rows as M minibatches: every field (M, B, ...)."""
    return Batch(*(f.view(m, -1, *f.shape[1:]) for f in batch))


def sum_skipped(metrics: dict, skipped):
    """The running sum of the guard's skip counts over the sub-steps of a
    dispatch (reference utils/health.py ``reduce_scan_metrics``)."""
    sk = metrics.get(SKIPPED_KEY)
    if sk is None:
        return skipped
    return sk if skipped is None else skipped + sk


def build_uniform_fused_step(train_step, batch_size: int,
                             steps_per_call: int = 1, megabatch: int = 1,
                             megabatch_step=None):
    """``fused(ts, rs, us (K, B), beta=None) -> (ts', metrics)``: K
    sub-steps of uniform sample -> train on the ring state ``rs``, which
    they only read (reference :202-260; ``beta`` is taken for the PER
    step's call and unused).  Metrics are the last sub-step's, except
    ``learner/skipped``, which sums over the K sub-steps.

    ``megabatch`` M > 1 (with ``megabatch_step`` from
    ``factory.build_megabatch_train_step``) regroups the K sub-steps into
    K/M groups: a group draws its M minibatches from the same uniforms
    the sequential schedule would (row m of the group's (M, B)), gathers
    them at once and runs them as one group step."""
    K, M = steps_per_call, megabatch
    if M > 1:
        if megabatch_step is None:
            raise ValueError("megabatch > 1 needs the factory's megabatch "
                             "step")
        if K % M:
            raise ValueError(f"megabatch {M} must divide steps_per_call {K}")

    def fused(ts, rs: ReplayState, us: torch.Tensor, beta=None):
        if tuple(us.shape) != (K, batch_size):
            raise ValueError(f"uniforms {tuple(us.shape)}, expected "
                             f"({K}, {batch_size})")
        skipped = None
        if M > 1:
            for g in range(K // M):
                idx = uniform_index(rs, us[g * M:(g + 1) * M].reshape(-1))
                ts, metrics, _td, _ok = megabatch_step(
                    ts, group_batches(sample_rows(rs, idx), M))
                skipped = sum_skipped(metrics, skipped)
        else:
            for k in range(K):
                ts, metrics, _td = train_step(
                    ts, sample_rows(rs, uniform_index(rs, us[k])))
                skipped = sum_skipped(metrics, skipped)
        if skipped is not None:
            metrics = dict(metrics, **{SKIPPED_KEY: skipped})
        return ts, metrics

    return fused


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
            cursor=z((), torch.int64), fill_rows=z((), torch.float32)))

    def _extend(self, columns: dict) -> ReplayState:
        return ReplayState(**columns)

    def feed_chunk(self, chunk: Transition,
                   non_blocking: bool = False) -> None:
        ring_write(self.state, chunk, self.capacity, non_blocking)

    def build_fused_step(self, train_step, batch_size: int,
                         steps_per_call: int = 1, megabatch: int = 1,
                         megabatch_step=None):
        """The uniform ring's fused step (``build_uniform_fused_step``)."""
        return build_uniform_fused_step(train_step, batch_size,
                                        steps_per_call, megabatch,
                                        megabatch_step)

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
        st.fill_rows.zero_()
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


STAGE_ROWS = 512   # rows per staging slab: 29 MB of config 12's frames
STAGE_SLABS = 3


class DeviceReplayIngest(SlotQueues):
    """Queue front end of the device ring (the transport and the
    quarantine are memory/feeder.py ``SlotQueues``'s): actor slot ``i``
    feeds through ``make_feeder(i)``; the learner calls
    ``attach(device)`` and then ``drain()`` between dispatches, which
    reads every slot's queue, stacks the rows into the staging slabs
    (``StagedWriter``) and writes them with one host-to-device copy per
    column and slab.  Its quarantine source is ``feeder-device``
    (reference :561-581)."""

    source = "feeder-device"
    prioritized = False

    def __init__(self, capacity: int, state_shape: Tuple[int, ...],
                 action_shape: Tuple[int, ...] = (),
                 state_dtype=np.uint8, action_dtype=np.int32,
                 max_queue_chunks: int = 4096, in_process: bool = False,
                 slots: int = 1, quarantine: bool = True,
                 quarantine_max_files: int = 64):
        super().__init__(state_shape, state_dtype,
                         max_queue_chunks=max_queue_chunks,
                         in_process=in_process, slots=slots,
                         quarantine=quarantine,
                         quarantine_max_files=quarantine_max_files)
        self.capacity = capacity
        self.action_shape = tuple(action_shape)
        self.action_dtype = np.dtype(action_dtype)
        self.replay: Optional[DeviceReplay] = None
        self.replay_b: Optional[DeviceReplay] = None
        self._staging: Optional[StagedWriter] = None
        self._pending: List[Transition] = []
        self._fed_total = 0

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
        fresh, _popped = self.read(max_chunks)
        self._pending.extend(fresh)
        n = min(len(self._pending), max_rows)
        rows, self._pending = self._pending[:n], self._pending[n:]
        if n:
            self._staging.write(rows)
        self._fed_total += n
        return n

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

    def xray(self) -> Optional[dict]:
        """The priority X-ray of the attached ring; None for the uniform
        one."""
        return None


class DevicePerIngest(DeviceReplayIngest):
    """Queue front end of the prioritized device ring (memory/device_per.py):
    new rows enter at the running max priority; priorities live and update
    on the device only."""

    prioritized = True

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

    def xray(self) -> dict:
        from pytorch_distributed_tpu_torch.memory.device_per import read_xray

        if self.replay is None:
            raise RuntimeError("attach() first")
        return read_xray(self.replay.state)


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=dt)).dtype
