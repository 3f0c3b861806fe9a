"""Sequence replay: contiguous episode segments for the recurrent learner
— the port of pytorch_distributed_tpu/memory/sequence_replay.py:31-380
(``Segment``, ``SegmentBatch``, ``SegmentBuilder`` and the host
``SequenceReplay``), numpy only, as the reference's.

One row is a fixed-length window of an episode:

    obs[T+1], action[T], reward[T], terminal[T], mask[T], (c0, h0)

where ``mask`` marks valid steps (episode tails are zero-padded) and
``(c0, h0)`` is the actor's LSTM carry at the segment's first step (the
"stored state" that the learner refreshes with a burn-in prefix,
ops/sequence_losses.py).  Segments overlap by ``overlap`` steps, never
across an episode's end.  ``pack_frames=C`` stores frame-stacked image
segments de-duplicated, as the (T+C, H, W) frame sequence.

The host ring samples proportionally over per-sequence priorities (the
learner's eta-blended |TD|, written back as ``(|td| + 1e-6) ** alpha``;
new rows enter at the running max) with IS weights normalised by the
smallest non-zero priority, and uniformly when alpha is 0, drawing from
the caller's numpy generator exactly as the reference draws.  It is
single-owner: actors stream segments through ``memory/feeder.py``'s
``QueueOwner``, and only the learner touches the arrays.  Its snapshot
has the keys and units of the device segment ring's
(memory/device_sequence.py), so either ring restores the other's.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from pytorch_distributed_tpu_torch.utils import health


class Segment(NamedTuple):
    """One replay row (unbatched).  ``prov`` is the optional provenance
    vector of the segment's first step (utils/experience.make_prov);
    storage keeps it in a sidecar array, not in the segment's columns
    (iterate the replay's ``_FIELDS`` for those)."""

    obs: np.ndarray        # (T+1, *state_shape)
    action: np.ndarray     # (T,) int32
    reward: np.ndarray     # (T,) float32
    terminal: np.ndarray   # (T,) float32
    mask: np.ndarray       # (T,) float32, 1 = valid step
    c0: np.ndarray         # (lstm_dim,) float32
    h0: np.ndarray         # (lstm_dim,) float32
    prov: Optional[np.ndarray] = None  # (4,) int64 provenance, or None


class SegmentBatch(NamedTuple):
    """A sampled minibatch of segments (leading batch dim everywhere)."""

    obs: np.ndarray        # (B, T+1, *state_shape)
    action: np.ndarray
    reward: np.ndarray
    terminal: np.ndarray
    mask: np.ndarray
    c0: np.ndarray         # (B, lstm_dim)
    h0: np.ndarray
    weight: np.ndarray     # (B,) importance weights
    index: np.ndarray      # (B,) rows, for priority write-back


class _BuilderStep(NamedTuple):
    """One pushed actor step held by SegmentBuilder before emit."""

    obs: np.ndarray
    action: int
    reward: float
    terminal: bool
    next_obs: np.ndarray
    c: np.ndarray
    h: np.ndarray
    prov: Optional[np.ndarray]


class SegmentBuilder:
    """Per-env online segment assembly with overlap.

    ``push`` receives one acted step — the observation the actor saw, the
    LSTM carry it held BEFORE acting (the state to store for this step),
    and the step outcome — and returns zero or more finished Segments.
    Episode ends flush a padded+masked tail and reset the stream (overlap
    never crosses episodes).

    ``pack_frames=C`` (image obs only) stores segments FRAME-PACKED:
    consecutive C-stacked observations share C-1 frames, so a stacked
    segment ships every pixel C times.  Packed, ``obs`` is the
    de-duplicated frame sequence (T+C, H, W) — stack t is frames
    [t, t+C) — cutting the actor->learner queue bytes, host RAM, and
    the per-update host->device transfer ~C-fold; the learner
    reconstructs stacks on device (ops/sequence_losses.py
    unpack_frame_stacks)."""

    def __init__(self, seq_len: int, overlap: int,
                 state_dtype=np.float32, pack_frames: int = 0):
        assert 0 <= overlap < seq_len, (overlap, seq_len)
        self.T = seq_len
        self.overlap = overlap
        self.state_dtype = np.dtype(state_dtype)
        self.pack_frames = int(pack_frames)
        self._checked_sliding = False  # one-time invariant check on emit
        self._steps: List[_BuilderStep] = []

    def push(self, obs, action, reward, terminal, next_obs,
             carry: Tuple[np.ndarray, np.ndarray],
             episode_end: Optional[bool] = None,
             prov=None) -> List[Segment]:
        """``terminal`` is what the learner bootstraps on (False for
        time-limit truncations, which must bootstrap through);
        ``episode_end`` (default: terminal) is what ends the stream — a
        truncated episode ends the segment without marking a death.
        ``prov`` is this step's provenance vector (minted at action
        time); an emitted segment carries its FIRST step's provenance,
        overlap included — the retained steps keep the vectors they were
        pushed with."""
        if episode_end is None:
            episode_end = bool(terminal)
        c, h = carry
        self._steps.append(_BuilderStep(
            obs=np.asarray(obs), action=int(action),
            reward=float(reward), terminal=bool(terminal),
            next_obs=np.asarray(next_obs),
            c=np.asarray(c, np.float32).copy(),
            h=np.asarray(h, np.float32).copy(), prov=prov))
        out: List[Segment] = []
        if episode_end:
            out.append(self._emit(len(self._steps)))
            self._steps = []  # no overlap across episode boundaries
        elif len(self._steps) == self.T:
            out.append(self._emit(self.T))
            keep = self.overlap
            self._steps = self._steps[len(self._steps) - keep:] if keep \
                else []
        return out

    def _emit(self, n: int) -> Segment:
        T = self.T
        steps = self._steps[:n]
        obs0 = steps[0].obs
        action = np.zeros(T, np.int32)
        reward = np.zeros(T, np.float32)
        terminal = np.zeros(T, np.float32)
        mask = np.zeros(T, np.float32)
        for t, s in enumerate(steps):
            action[t] = s.action
            reward[t] = s.reward
            terminal[t] = float(s.terminal)
            mask[t] = 1.0
        if self.pack_frames:
            obs = self._emit_packed(steps, n)
        else:
            obs = np.zeros((T + 1, *obs0.shape), dtype=self.state_dtype)
            for t, s in enumerate(steps):
                obs[t] = s.obs
            obs[n] = steps[n - 1].next_obs  # bootstrap observation
            # pad slots keep the bootstrap obs so scans stay shape-static
            for t in range(n + 1, T + 1):
                obs[t] = obs[n]
        return Segment(obs=obs, action=action, reward=reward,
                       terminal=terminal, mask=mask,
                       c0=steps[0].c, h0=steps[0].h, prov=steps[0].prov)

    def _emit_packed(self, steps, n: int) -> np.ndarray:
        """De-duplicated frame sequence (T+C, H, W): frames [0, C) are
        step 0's full stack, frame C-1+t is step t's newest frame, frame
        C-1+n the bootstrap's newest; pad frames repeat the bootstrap
        frame (padded positions are mask=0 and the n-step bootstrap index
        clamps to <= n_valid, so reconstructed pad stacks are never
        read)."""
        C, T = self.pack_frames, self.T
        obs0 = steps[0].obs
        assert obs0.shape[0] == C, (
            f"pack_frames={C} but stacked obs has {obs0.shape[0]} channels")
        if not self._checked_sliding and n >= 2:
            # Packing is only sound for sliding-window stacks (each push's
            # stack = previous stack shifted one frame).  A non-sliding
            # env would pass the shape assert yet reconstruct corrupted
            # channels — check the invariant once, on the first real
            # segment, at negligible cost.
            self._checked_sliding = True
            assert np.array_equal(steps[1].obs[:-1], steps[0].obs[1:]), (
                "pack_frames set but observations are not a sliding "
                "frame-stack (obs[t][:-1] != obs[t-1][1:]); disable "
                "packing for this env")
            # next_obs must slide from obs the same way: the bootstrap
            # frame is taken from next_obs[-1] (frames[C-1+n] below), so
            # an env wrapper handing back e.g. the post-reset observation
            # as next_obs would silently store a wrong bootstrap frame at
            # truncation-style segment ends
            assert np.array_equal(steps[0].next_obs[:-1],
                                  steps[0].obs[1:]), (
                "pack_frames set but next_obs does not slide from obs "
                "(next_obs[:-1] != obs[1:]); disable packing for this env")
        frames = np.zeros((T + C, *obs0.shape[1:]), dtype=self.state_dtype)
        frames[:C] = obs0
        for t in range(1, n):
            frames[C - 1 + t] = steps[t].obs[-1]
        frames[C - 1 + n] = steps[n - 1].next_obs[-1]  # bootstrap frame
        for t in range(n + 1, T + 1):
            frames[C - 1 + t] = frames[C - 1 + n]
        return frames

    def reset(self) -> None:
        self._steps = []


class SequenceReplay:
    """Ring of segments with proportional prioritized sampling.

    ``capacity`` counts SEGMENTS (the factory divides the transition-count
    memory_size by the segment stride).  ``state_shape`` and
    ``state_dtype`` are one step's observation, as the queue owner's
    validator reads them; a row's ``obs`` is the window's."""

    prioritized = True  # the learner writes |TD| back

    def __init__(self, capacity: int, seq_len: int,
                 state_shape: Tuple[int, ...], lstm_dim: int,
                 state_dtype=np.float32,
                 priority_exponent: float = 0.9,
                 importance_weight: float = 0.6,
                 importance_anneal_steps: int = 500000,
                 pack_frames: int = 0):
        self.capacity = capacity
        self.T = seq_len
        self.lstm_dim = lstm_dim
        self.alpha = priority_exponent
        self.beta0 = importance_weight
        self.beta_steps = importance_anneal_steps
        self.pack_frames = int(pack_frames)
        S = self.state_shape = tuple(state_shape)
        self.state_dtype = np.dtype(state_dtype)
        if self.pack_frames:
            # frame-packed rows: (T+C, H, W) — see SegmentBuilder
            assert S[0] == self.pack_frames, (S, pack_frames)
            obs_shape = (seq_len + self.pack_frames, *S[1:])
        else:
            obs_shape = (seq_len + 1, *S)
        self.obs = np.zeros((capacity, *obs_shape), dtype=state_dtype)
        self.action = np.zeros((capacity, seq_len), np.int32)
        self.reward = np.zeros((capacity, seq_len), np.float32)
        self.terminal = np.zeros((capacity, seq_len), np.float32)
        self.mask = np.zeros((capacity, seq_len), np.float32)
        self.c0 = np.zeros((capacity, lstm_dim), np.float32)
        self.h0 = np.zeros((capacity, lstm_dim), np.float32)
        # provenance sidecar: first-step provenance per segment, -1
        # rows = unknown
        self.prov = np.full((capacity, 4), -1, np.int64)
        self.priority = np.zeros(capacity, np.float64)  # p^alpha, 0 = empty
        self.max_priority = 1.0
        self.pos = 0
        self.full = False
        self.samples_drawn = 0

    @property
    def size(self) -> int:
        return self.capacity if self.full else self.pos

    def feed(self, segment: Segment, priority: Optional[float] = None
             ) -> None:
        i = self.pos
        self.obs[i] = segment.obs
        self.action[i] = segment.action
        self.reward[i] = segment.reward
        self.terminal[i] = segment.terminal
        self.mask[i] = segment.mask
        self.c0[i] = segment.c0
        self.h0[i] = segment.h0
        self.prov[i] = (-1 if getattr(segment, "prov", None) is None
                        else segment.prov)
        if priority is None:
            self.priority[i] = self.max_priority
        else:
            p = (abs(float(priority)) + 1e-6) ** self.alpha
            self.priority[i] = p
            self.max_priority = max(self.max_priority, p)
        self.pos += 1
        if self.pos == self.capacity:
            self.pos = 0
            self.full = True

    def beta(self) -> float:
        frac = min(1.0, self.samples_drawn / max(1, self.beta_steps))
        return self.beta0 + (1.0 - self.beta0) * frac

    def sample(self, batch_size: int, rng: np.random.Generator
               ) -> SegmentBatch:
        n = self.size
        assert n > 0, "sample from empty sequence replay"
        if self.alpha == 0.0:
            idx = rng.integers(0, n, size=batch_size)
            weights = np.ones(batch_size, np.float32)
        else:
            p = self.priority[:n]
            total = p.sum()
            cdf = np.cumsum(p)
            u = rng.random(batch_size) * total
            idx = np.minimum(np.searchsorted(cdf, u, side="right"), n - 1)
            probs = p[idx] / max(total, 1e-12)
            beta = self.beta()
            weights = (n * np.maximum(probs, 1e-12)) ** (-beta)
            min_p = p[p > 0].min() / max(total, 1e-12)
            weights /= max((n * max(min_p, 1e-12)) ** (-beta), 1e-12)
            weights = weights.astype(np.float32)
        self.samples_drawn += batch_size
        return SegmentBatch(
            obs=self.obs[idx], action=self.action[idx],
            reward=self.reward[idx], terminal=self.terminal[idx],
            mask=self.mask[idx], c0=self.c0[idx], h0=self.h0[idx],
            weight=weights, index=idx.astype(np.int32))

    def priority_leaves(self) -> np.ndarray:
        """The valid rows' priorities (p^alpha) — the priority X-ray's
        input (utils/health.priority_xray)."""
        return self.priority[:self.size]

    def xray(self) -> dict:
        return health.ring_xray(self.priority_leaves())

    def provenance_of(self, indices: np.ndarray) -> np.ndarray:
        """(B, 4) int64 provenance of the given rows; -1 rows = unknown
        (the learner's data-plane telemetry masks on ``[:, 0] >= 0``)."""
        return self.prov[np.asarray(indices)]

    def update_priorities(self, indices: np.ndarray,
                          priorities: np.ndarray) -> None:
        """Per-sequence |TD| write-back (eta-blended by the learner)."""
        pr = (np.abs(np.asarray(priorities, np.float64)) + 1e-6) ** self.alpha
        self.priority[np.asarray(indices)] = pr
        if pr.size:
            self.max_priority = max(self.max_priority, float(pr.max()))

    # -- checkpoint (utils/checkpoint.py save_replay/load_replay) -----------

    _FIELDS = ("obs", "action", "reward", "terminal", "mask", "c0", "h0")

    def snapshot(self) -> dict:
        """Valid rows in AGE order (oldest first) + the priority leaves —
        the same keys and units as the HBM segment ring
        (memory/device_sequence.py snapshot), so host and device sequence
        planes restore each other's checkpoints: leaves pre-exponentiated
        p^alpha, running max in the shared UNexponentiated base unit."""
        n = self.size
        shift = -self.pos if self.full else 0
        out = {k: np.roll(getattr(self, k), shift, axis=0)[:n].copy()
               for k in self._FIELDS}
        out["prov"] = np.roll(self.prov, shift, axis=0)[:n].copy()
        out["leaf_priority"] = np.roll(self.priority, shift)[:n].copy()
        out["max_priority_base"] = np.float64(
            self.max_priority ** (1.0 / self.alpha) if self.alpha
            else self.max_priority)
        # the exponent the leaves were saved under, so a restoring run
        # with a different alpha converts instead of mixing units (same
        # convention as memory/prioritized.py)
        out["alpha"] = np.float64(self.alpha)
        out["samples_drawn"] = np.int64(self.samples_drawn)
        return out

    def restore(self, data: dict) -> int:
        """Refill from a snapshot (keeps the newest rows that fit);
        returns rows restored."""
        rows = np.asarray(data["reward"])
        n = min(len(rows), self.capacity)
        for k in self._FIELDS:
            getattr(self, k)[:n] = data[k][-n:]
        self.prov[:n] = (np.asarray(data["prov"], np.int64)[-n:]
                         if "prov" in data else -1)
        self.prov[n:] = -1
        if "leaf_priority" in data:
            leaves = np.asarray(data["leaf_priority"], np.float64)[-n:]
            saved_alpha = float(data.get("alpha", self.alpha))
            if saved_alpha != self.alpha and saved_alpha > 0:
                leaves = leaves ** (self.alpha / saved_alpha)
        else:  # priority-less source: everything replays at least once
            leaves = np.full(n, self.max_priority, np.float64)
        self.priority[:n] = leaves
        # rows beyond the restored region must never be drawn (0 = empty)
        self.priority[n:] = 0.0
        self.pos = n % self.capacity
        self.full = n == self.capacity
        base = float(data.get("max_priority_base", 1.0))
        self.max_priority = base ** self.alpha if self.alpha else base
        self.samples_drawn = int(data.get("samples_drawn", 0))
        return n
