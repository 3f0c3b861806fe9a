"""The R2D2 segment ring in device memory, fused into the learner — the port
of pytorch_distributed_tpu/memory/device_sequence.py: ``SegmentChunk``
and ``SeqReplayState`` (:46-70), ``seq_feed`` (:73-91), ``seq_sample``
(:94-120), ``seq_update_priorities`` (:123-133), ``DeviceSequenceReplay``
with ``build_fused_step`` and its checkpoint surface (:136-279), and the
queue front end ``DeviceSequenceIngest`` (:281-444).

The segment columns (frame-packed (T+C, H, W) uint8 frames for the pixel
row, so the ring holds every frame once) and the priorities live as
tensors on the learner's device.  Priorities are stored pre-exponentiated
(``(|td| + 1e-6) ** alpha``), new rows enter at the running max, and the
IS weights are normalised by the weight of the smallest non-zero
priority.  The draw is the reference's flat inverse CDF, ``torch.cumsum``
and ``torch.searchsorted`` over the ring's priorities, on uniforms the
caller draws (the learner from its device generator, the tests from
numpy): a segment ring is small (config 14's holds 1,250 rows), and the
reference keeps it off its Pallas sampler, so kernel B1 does not serve
it.

As the port's other device rings, this one is written in place: the
write cursor and the fill are host integers, ``fill_rows`` their device
copy, and a write copies into the columns' slices.  ``build_fused_step``
runs K sub-steps of sample -> train -> priority write-back on the ring
(``fused(ts, rs, us (K, B), beta) -> (ts', metrics)``, the PER ring's
call), each sampling from the priorities the previous one wrote; a
sub-step the finite guard skipped writes nothing back.  On a GPU the
learner replays it from a CUDA graph (memory/device_per.py
``GraphedFusedStep``).  The sequence family has no megabatch group step.

``DeviceSequenceIngest`` is the learner's end of the actors' queues
(memory/feeder.py ``SlotQueues``: a queue per actor slot, the
quarantine): ``drain`` stacks the pending segments into chunks of the
reference's sizes (``chunk_size * 8``, then ``chunk_size``; a remainder
smaller than the smallest waits for the next drain, at most ``max_rows``
a drain) and writes each with one copy per column.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch.memory.device_per import (
    is_weights, per_update_priorities,
)
from pytorch_distributed_tpu_torch.memory.device_replay import sum_skipped
from pytorch_distributed_tpu_torch.memory.feeder import SlotQueues
from pytorch_distributed_tpu_torch.memory.sequence_replay import (
    SegmentBatch,
)
from pytorch_distributed_tpu_torch.ops.losses import SKIPPED_KEY


class SegmentChunk(NamedTuple):
    """A stack of segments (leading chunk dim), the Segment schema's
    columns."""

    obs: np.ndarray        # (n, T+C, H, W) packed / (n, T+1, *S) unpacked
    action: np.ndarray     # (n, T) int32
    reward: np.ndarray     # (n, T) float32
    terminal: np.ndarray   # (n, T) float32
    mask: np.ndarray       # (n, T) float32
    c0: np.ndarray         # (n, lstm_dim) float32
    h0: np.ndarray         # (n, lstm_dim) float32


FIELDS = SegmentChunk._fields


@dataclass
class SeqReplayState:
    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    terminal: torch.Tensor
    mask: torch.Tensor
    c0: torch.Tensor
    h0: torch.Tensor
    priority: torch.Tensor      # (N,) f32 p ** alpha; 0 = empty
    max_priority: torch.Tensor  # () f32 running max of p ** alpha
    fill_rows: torch.Tensor     # () f32 valid rows, on the device
    pos: int = 0                # write cursor
    fill: int = 0               # valid rows


def seq_feed(state: SeqReplayState, chunk: SegmentChunk, capacity: int,
             non_blocking: bool = False) -> None:
    """Write a chunk (``n <= capacity`` rows, numpy arrays or CPU tensors)
    at the cursor, in place; the new rows take the running max priority."""
    n = int(np.shape(chunk.reward)[0])
    if not 0 < n <= capacity:
        raise ValueError(f"chunk of {n} segments for a ring of {capacity}")
    first = min(n, capacity - state.pos)
    spans = [(state.pos, state.pos + first, 0)]
    if first < n:
        spans.append((0, n - first, first))
    for f in FIELDS:
        col, src = getattr(state, f), torch.as_tensor(getattr(chunk, f))
        for lo, hi, off in spans:
            col[lo:hi].copy_(src[off:off + hi - lo],
                             non_blocking=non_blocking)
    for lo, hi, _off in spans:
        state.priority[lo:hi] = state.max_priority
    state.pos = (state.pos + n) % capacity
    state.fill = min(state.fill + n, capacity)
    state.fill_rows.fill_(float(state.fill))


def seq_sample(state: SeqReplayState, u: torch.Tensor,
               beta) -> SegmentBatch:
    """Proportional segment sample of ``len(u)`` rows plus IS weights, on
    the ring's device: ``u`` in [0, 1) scales the priority mass, and the
    index is the first row whose running sum exceeds it (empty rows hold
    0 and are never drawn); ``beta`` is a float or a () tensor."""
    p = state.priority
    cdf = torch.cumsum(p, 0)
    total = cdf[-1]
    idx = torch.clamp(torch.searchsorted(cdf, u * total, right=True),
                      0, p.shape[0] - 1)
    probs = p[idx] / torch.clamp(total, min=1e-12)
    return SegmentBatch(
        obs=state.obs[idx], action=state.action[idx],
        reward=state.reward[idx], terminal=state.terminal[idx],
        mask=state.mask[idx], c0=state.c0[idx], h0=state.h0[idx],
        weight=is_weights(p, total, probs, state.fill_rows, beta),
        index=idx)


# the sequence priorities' write-back, ``(|td| + eps) ** alpha``, and the
# running max, in place, a row drawn twice keeping its last position's
# value, nothing written on a guard-skipped step: the PER ring's
seq_update_priorities = per_update_priorities


class DeviceSequenceReplay:
    """Owner of the segment ring's tensors (the learner's process)."""

    def __init__(self, capacity: int, seq_len: int,
                 state_shape: Tuple[int, ...], lstm_dim: int,
                 state_dtype=torch.uint8, priority_exponent: float = 0.9,
                 importance_weight: float = 0.6,
                 importance_anneal_steps: int = 500000,
                 pack_frames: int = 0, device="cpu"):
        self.capacity = capacity
        self.T = seq_len
        self.lstm_dim = lstm_dim
        self.alpha = priority_exponent
        self.beta0 = importance_weight
        self.beta_steps = importance_anneal_steps
        self.pack_frames = int(pack_frames)
        self.device = torch.device(device)
        S = self.state_shape = tuple(state_shape)
        if self.pack_frames:
            # frame-packed rows (T+C, H, W): the stacks are rebuilt by the
            # train step (ops/sequence_losses.unpack_frame_stacks)
            if S[0] != self.pack_frames:
                raise ValueError(f"pack_frames={pack_frames} for stacks "
                                 f"of shape {S}")
            self.obs_shape = (seq_len + self.pack_frames, *S[1:])
        else:
            self.obs_shape = (seq_len + 1, *S)
        N, T = capacity, seq_len
        z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=self.device)
        self.state = SeqReplayState(
            obs=z((N, *self.obs_shape), state_dtype),
            action=z((N, T), torch.int32), reward=z((N, T), torch.float32),
            terminal=z((N, T), torch.float32), mask=z((N, T), torch.float32),
            c0=z((N, lstm_dim), torch.float32),
            h0=z((N, lstm_dim), torch.float32),
            priority=z((N,), torch.float32),
            max_priority=torch.ones((), device=self.device),
            fill_rows=z((), torch.float32))

    @property
    def size(self) -> int:
        return self.state.fill

    def beta(self, step: int) -> float:
        frac = min(1.0, step / max(1, self.beta_steps))
        return self.beta0 + (1.0 - self.beta0) * frac

    def feed_chunk(self, chunk: SegmentChunk,
                   non_blocking: bool = False) -> None:
        seq_feed(self.state, chunk, self.capacity, non_blocking)

    def build_fused_step(self, train_step, batch_size: int,
                         steps_per_call: int = 1, megabatch: int = 1,
                         megabatch_step=None):
        """``fused(ts, rs, us (K, B), beta) -> (ts', metrics)``: K sub-steps
        of sample -> burn-in/train -> priority write-back on the ring state
        ``rs`` (updated in place).  Metrics are the last sub-step's, except
        ``learner/skipped``, which sums over the K.  No megabatch: the
        factory has no group step for the sequence family."""
        if megabatch > 1 or megabatch_step is not None:
            raise ValueError("the segment ring has no megabatch group step")
        alpha, K = self.alpha, steps_per_call

        def fused(ts, rs: SeqReplayState, us: torch.Tensor, beta):
            if tuple(us.shape) != (K, batch_size):
                raise ValueError(f"uniforms {tuple(us.shape)}, expected "
                                 f"({K}, {batch_size})")
            skipped = None
            for k in range(K):
                batch = seq_sample(rs, us[k], beta)
                ts, metrics, seq_pr = train_step(ts, batch)
                seq_update_priorities(rs, batch.index, seq_pr, alpha,
                                      metrics.get(SKIPPED_KEY))
                skipped = sum_skipped(metrics, skipped)
            if skipped is not None:
                metrics = dict(metrics, **{SKIPPED_KEY: skipped})
            return ts, metrics

        return fused

    def _age_order(self, col: torch.Tensor) -> np.ndarray:
        st = self.state
        if st.fill == self.capacity and st.pos:
            col = torch.cat([col[st.pos:], col[:st.pos]])
        else:
            col = col[:st.fill]
        return col.cpu().numpy().copy()

    def snapshot(self) -> dict:
        """The valid rows to the host, oldest first, with the priority
        leaves (``p ** alpha``) and the running max in the unexponentiated
        unit (``max_priority_base``), the host segment ring's keys."""
        out = {f: self._age_order(getattr(self.state, f)) for f in FIELDS}
        out["leaf_priority"] = self._age_order(self.state.priority)
        mx = float(self.state.max_priority)
        out["max_priority_base"] = np.float64(
            mx ** (1.0 / self.alpha) if self.alpha else mx)
        return out

    def _reset(self) -> None:
        """Empty the ring in place (a captured graph reads its tensors)."""
        st = self.state
        for f in FIELDS:
            getattr(st, f).zero_()
        st.priority.zero_()
        st.max_priority.fill_(1.0)
        st.fill_rows.zero_()
        st.pos = st.fill = 0

    def restore(self, data: dict) -> int:
        """Refill through the ring write (the newest rows that fit), then
        overwrite the new rows' max priorities with the saved leaves, so
        the draws go on where they stopped.  Returns the rows restored."""
        self._reset()
        n = min(len(np.asarray(data["reward"])), self.capacity)
        if n:
            self.feed_chunk(SegmentChunk(*(np.ascontiguousarray(
                np.asarray(data[f])[-n:]) for f in FIELDS)))
            st = self.state
            if "leaf_priority" in data:
                idx = torch.arange(st.pos - n, st.pos) % self.capacity
                st.priority[idx.to(self.device)] = torch.as_tensor(
                    np.asarray(data["leaf_priority"], np.float32)[-n:]).to(
                    self.device)
                base = float(data.get("max_priority_base", 1.0))
                st.max_priority.fill_(float(np.float32(
                    base ** self.alpha if self.alpha else base)))
        return n


class DeviceSequenceIngest(SlotQueues):
    """The queue front end of the segment ring: actor slot ``i`` feeds
    Segments through ``make_feeder(i)``; the learner calls
    ``attach(device)`` and then ``drain()`` between dispatches.  The same
    learner surface as the device PER ring's ingest (``attach``,
    ``drain``, ``size``, ``capacity``, ``replay.build_fused_step``,
    ``replay.beta``, ``snapshot``/``restore``, ``xray``)."""

    source = "feeder-device"
    prioritized = True

    def __init__(self, capacity: int, seq_len: int,
                 state_shape: Tuple[int, ...], lstm_dim: int,
                 state_dtype=np.uint8, priority_exponent: float = 0.9,
                 importance_weight: float = 0.6,
                 importance_anneal_steps: int = 500000,
                 pack_frames: int = 0, chunk_size: int = 16,
                 max_queue_chunks: int = 4096, in_process: bool = False,
                 slots: int = 1, quarantine: bool = True,
                 quarantine_max_files: int = 64):
        super().__init__(state_shape, state_dtype,
                         max_queue_chunks=max_queue_chunks,
                         in_process=in_process, slots=slots,
                         quarantine=quarantine,
                         quarantine_max_files=quarantine_max_files)
        self.capacity = capacity
        self.seq_len = seq_len
        self.lstm_dim = lstm_dim
        self.priority_exponent = priority_exponent
        self.importance_weight = importance_weight
        self.importance_anneal_steps = importance_anneal_steps
        self.pack_frames = int(pack_frames)
        # largest first: a deep backlog moves in few large copies
        self.chunk_sizes = tuple(sorted(
            {min(s, capacity) for s in (chunk_size, chunk_size * 8)},
            reverse=True))
        self.replay: Optional[DeviceSequenceReplay] = None
        self._pending: List = []
        self._fed_total = 0

    def attach(self, device) -> DeviceSequenceReplay:
        self.replay = DeviceSequenceReplay(
            self.capacity, self.seq_len, self.state_shape, self.lstm_dim,
            state_dtype=torch.from_numpy(
                np.zeros(0, self.state_dtype)).dtype,
            priority_exponent=self.priority_exponent,
            importance_weight=self.importance_weight,
            importance_anneal_steps=self.importance_anneal_steps,
            pack_frames=self.pack_frames, device=device)
        return self.replay

    @property
    def size(self) -> int:
        if self.replay is None:
            raise RuntimeError("attach() first")
        return min(self._fed_total, self.capacity)

    def drain(self, max_chunks: int = 1024, max_rows: int = 512) -> int:
        """Move queued segments into the ring in chunks of
        ``chunk_sizes``; at most ``max_rows`` a call.  Returns rows
        written."""
        if self.replay is None:
            raise RuntimeError("attach() first")
        fresh, _popped = self.read(max_chunks)
        self._pending.extend(fresh)
        fed = 0
        while fed < max_rows:
            C = next((s for s in self.chunk_sizes
                      if s <= len(self._pending)), None)
            if C is None:
                break
            rows, self._pending = self._pending[:C], self._pending[C:]
            self.replay.feed_chunk(self._stack(rows))
            fed += C
        self._fed_total += fed
        return fed

    def _stack(self, rows) -> SegmentChunk:
        dt = {"obs": self.state_dtype, "action": np.int32}
        return SegmentChunk(*(
            np.stack([getattr(r, f) for r in rows]).astype(
                dt.get(f, np.float32), copy=False) for f in FIELDS))

    def snapshot(self) -> dict:
        """Every queued segment into the ring (the remainder below the
        smallest chunk too), then the ring's snapshot."""
        if self.replay is None:
            raise RuntimeError("attach() first")
        while self.drain():
            pass
        if self._pending:
            rows, self._pending = self._pending, []
            self.replay.feed_chunk(self._stack(rows))
            self._fed_total += len(rows)
        return self.replay.snapshot()

    def restore(self, data: dict) -> int:
        if self.replay is None:
            raise RuntimeError("attach() first")
        n = self.replay.restore(data)
        self._fed_total = n  # the ring was emptied first
        return n

    def xray(self) -> dict:
        """The priority X-ray of the attached ring (memory/device_per.py
        ``read_xray``: it reads only ``priority``)."""
        from pytorch_distributed_tpu_torch.memory.device_per import read_xray

        if self.replay is None:
            raise RuntimeError("attach() first")
        return read_xray(self.replay.state)
