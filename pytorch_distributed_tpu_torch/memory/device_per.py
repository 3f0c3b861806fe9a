"""Prioritized replay in device memory, fused into the learner step — the
port of pytorch_distributed_tpu/memory/device_per.py: ``per_feed``
(:59-64), ``per_sample`` (:86-120), ``per_update_priorities`` (:153-161),
``DevicePerReplay`` (:203-257) with its checkpoint surface
(``snapshot``/``restore`` :355-392), ``build_fused_step`` with its
sequential arm (:327-351) and its megabatch arm (:259-325),
``per_apply_writeback_groups`` (:170-190) and the priority X-ray
(``priority_xray_device`` :127-154).

Priorities are stored pre-exponentiated (``p = (|td| + eps) ** alpha``);
new rows enter at the running max priority so every row is replayed at
least once.  IS weights are normalised by the weight of the
minimum-probability valid row and annealed by ``beta``.

The fused step runs K sub-steps of sample -> train -> priority write-back as
a Python loop (the reference's ``lax.scan``), each sub-step sampling from
the priorities the previous one wrote. Under megabatch M it runs K/M groups:
a group draws its M*B rows in one launch of the draw from the group-entry
priorities (the IS weights' maximum comes from the ring's minimum priority,
not from the batch, so one widened draw is M draws), runs the group step,
then writes the M |TD| rows back in minibatch order, one write-back each, so
that a row drawn by two minibatches keeps the later one's priority; a
skipped minibatch writes nothing back. It takes the uniforms of all K draws
as one (K, B) tensor, which the learner draws from its device generator and
the tests hand in. The draw is kernel B1
(``ops/cuda_sampling.hierarchical_sample``): the kernel on a CUDA ring, its
plain version on a CPU ring. Ring and priorities are updated in place.

On a CUDA ring the learner replays the fused step from a CUDA graph
(``GraphedFusedStep``), the counterpart of the reference's one jitted XLA
program per dispatch: one replay launches every kernel of the K sub-steps,
so the host pays one call per dispatch instead of several hundred small
ones.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from pytorch_distributed_tpu_torch.memory.device_replay import (
    DeviceReplay, ReplayState, _masked_put, group_batches,
    masked_write_index, ring_write, ring_write_masked, sum_skipped,
)
from pytorch_distributed_tpu_torch.ops.cuda_sampling import (
    hierarchical_sample,
)
from pytorch_distributed_tpu_torch.ops.losses import SKIPPED_KEY
from pytorch_distributed_tpu_torch.utils.experience import Batch, Transition


@dataclass
class PerReplayState(ReplayState):
    priority: Optional[torch.Tensor] = None      # (N,) f32 p**alpha; 0 = empty
    max_priority: Optional[torch.Tensor] = None  # () f32 running max


def per_feed(state: PerReplayState, chunk: Transition, capacity: int,
             non_blocking: bool = False) -> None:
    """Ring write at the cursor; the new rows take the running max."""
    for start, stop in ring_write(state, chunk, capacity, non_blocking):
        state.priority[start:stop] = state.max_priority


def per_write_masked(state: PerReplayState, chunk: Transition,
                     valid: torch.Tensor, capacity: int) -> torch.Tensor:
    """The masked twin of ``per_feed`` for writes inside a device program
    (reference memory/device_per.py:67-83): ``ring_write_masked``, and
    every written row enters at the running max priority.  Returns the
    count written, on the device."""
    idx, _total = masked_write_index(state, valid, capacity)
    total = ring_write_masked(state, chunk, valid, capacity)
    _masked_put(state.priority, idx, valid,
                state.max_priority.expand(valid.shape))
    return total


def per_sample(state: PerReplayState, u: torch.Tensor, beta,
               sample_fn: Callable = hierarchical_sample) -> Batch:
    """Proportional sample of ``len(u)`` rows plus IS weights.
    ``sample_fn(priority, u) -> (idx, probs)`` is the draw hook; ``beta``
    is a float or a () tensor."""
    p = state.priority
    idx, probs = sample_fn(p, u)
    total = torch.sum(p)
    fill = torch.clamp(state.fill_rows, min=1.0)
    weights = (fill * torch.clamp(probs, min=1e-12)) ** (-beta)
    min_p = (torch.min(torch.where(p > 0, p, torch.full_like(p, torch.inf)))
             / torch.clamp(total, min=1e-12))
    max_w = (fill * torch.clamp(min_p, min=1e-12)) ** (-beta)
    weights = weights / torch.clamp(max_w, min=1e-12)
    return Batch(
        state0=state.state0[idx], action=state.action[idx],
        reward=state.reward[idx], gamma_n=state.gamma_n[idx],
        state1=state.state1[idx], terminal1=state.terminal1[idx],
        weight=weights.float(), index=idx)


PRIORITY_XRAY_LOG10_LO = -6.0   # the log10 grid's floor (p ** alpha)
PRIORITY_XRAY_LOG10_HI = 3.0    # and its ceiling


def priority_xray_device(state: PerReplayState, bins: int = 16):
    """The priority X-ray of the ring's non-empty rows on the ring's own
    device (reference memory/device_per.py:127-154): a histogram over the
    fixed [1e-6, 1e3) log10 grid of utils/health.priority_xray, the
    effective sample size ``(sum p)^2 / sum p^2``, the row count and the
    priority mass.  Returns ``(counts (bins,) int32, ess, rows, mass)`` as
    device tensors; the learner reads them once a stats window, outside
    the captured graph, in one small copy to the host."""
    p = state.priority
    valid = p > 0
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    rows = valid.sum(dtype=torch.int32)
    s1 = torch.where(valid, p, zero).sum()
    s2 = torch.where(valid, p * p, zero).sum()
    ess = torch.where(s2 > 0, s1 * s1 / torch.clamp(s2, min=1e-30), zero)
    logp = torch.log10(torch.clamp(p, min=10.0 ** PRIORITY_XRAY_LOG10_LO))
    t = (logp - PRIORITY_XRAY_LOG10_LO) / (
        PRIORITY_XRAY_LOG10_HI - PRIORITY_XRAY_LOG10_LO)
    b = torch.clamp((t * bins).to(torch.int64), 0, bins - 1)
    # empty rows go to an overflow bin that is dropped: no mask indexing,
    # which would wait on the device for the row count
    counts = torch.zeros(bins + 1, dtype=torch.int32, device=p.device)
    counts.scatter_add_(0, torch.where(valid, b, bins),
                        torch.ones_like(b, dtype=torch.int32))
    return counts[:bins], ess, rows, s1


def read_xray(ring_state) -> dict:
    """The priority X-ray of a PER ring (``priority_xray_device``) on the
    host, in one copy: ``counts``, ``ess``, ``rows``, ``mass`` and
    ``ess_frac`` (None for an empty ring)."""
    counts, ess, rows, mass = priority_xray_device(ring_state)
    host = torch.cat([counts.to(torch.float64),
                      torch.stack([ess, rows.to(ess.dtype), mass]
                                  ).to(torch.float64)]).cpu()
    ess, n = float(host[-3]), int(host[-2])
    return {"counts": host[:-3].to(torch.int64).numpy(), "ess": ess,
            "rows": n, "mass": float(host[-1]),
            "ess_frac": ess / n if n else None}


def per_update_priorities(state: PerReplayState, idx: torch.Tensor,
                          td_abs: torch.Tensor, alpha: float,
                          skipped: Optional[torch.Tensor] = None,
                          epsilon: float = 1e-6) -> None:
    """|TD| write-back (pre-exponentiated) and running-max update, in place.

    Duplicate indices resolve deterministically as last-in-batch wins (the
    reference's scatter order): every position of a duplicated index writes
    the value of that index's last position, so which write lands does not
    matter.  With ``skipped`` >= 0.5 (the guard's flag) the old values are
    written back and the max is kept, with no host sync."""
    pr = ((torch.abs(td_abs) + epsilon) ** alpha).float()
    pos = torch.arange(idx.numel(), device=idx.device)
    last = torch.where(idx[:, None] == idx[None, :], pos[None, :],
                       -1).amax(1)
    vals = pr[last]
    new_max = torch.maximum(state.max_priority, torch.max(pr))
    if skipped is not None:
        keep = skipped >= 0.5
        vals = torch.where(keep, state.priority[idx], vals)
        new_max = torch.where(keep, state.max_priority, new_max)
    state.priority[idx] = vals
    state.max_priority.copy_(new_max)


def per_apply_writeback_groups(state: PerReplayState, groups,
                               alpha: float) -> None:
    """Apply an ordered list of ``(idx, td_abs)`` write-backs in turn
    (reference :170-190), so an index that two groups share keeps the
    later group's priority: one scatter over duplicate indices from
    several groups would leave the order to the device."""
    dev = state.priority.device
    for idx, td in groups:
        per_update_priorities(state, torch.as_tensor(idx).to(dev),
                              torch.as_tensor(td, dtype=torch.float32).to(dev),
                              alpha)


class DevicePerReplay(DeviceReplay):
    """The device ring extended with priorities and their running max."""

    def __init__(self, capacity: int, state_shape, action_shape=(),
                 state_dtype=torch.uint8, action_dtype=torch.int32,
                 device="cpu", priority_exponent: float = 0.6,
                 importance_weight: float = 0.4,
                 importance_anneal_steps: int = 500000):
        self.alpha = priority_exponent
        self.beta0 = importance_weight
        self.beta_steps = importance_anneal_steps
        super().__init__(capacity, state_shape, action_shape, state_dtype,
                         action_dtype, device)

    def _extend(self, columns: dict) -> PerReplayState:
        return PerReplayState(
            **columns,
            priority=torch.zeros(self.capacity, dtype=torch.float32,
                                 device=self.device),
            max_priority=torch.ones((), dtype=torch.float32,
                                    device=self.device))

    def feed_chunk(self, chunk: Transition,
                   non_blocking: bool = False) -> None:
        per_feed(self.state, chunk, self.capacity, non_blocking)

    def snapshot(self) -> dict:
        """The ring's snapshot plus the priorities: ``leaf_priority``, the
        rows' stored ``p ** alpha`` in age order, and
        ``max_priority_base``, the running max in the unexponentiated
        unit, as the reference writes them."""
        out = super().snapshot()
        out["leaf_priority"] = self._age_order(self.state.priority)
        mx = float(self.state.max_priority)
        out["max_priority_base"] = np.float64(
            mx ** (1.0 / self.alpha) if self.alpha else mx)
        return out

    def _reset(self) -> None:
        super()._reset()
        self.state.priority.zero_()
        self.state.max_priority.fill_(1.0)

    def restore(self, data: dict) -> int:
        """The rows enter at the max priority through the ring write, then
        the saved priorities overwrite theirs, so sampling goes on where
        it stopped."""
        n = super().restore(data)
        if n and "leaf_priority" in data:
            st = self.state
            idx = torch.arange(st.pos - n, st.pos) % self.capacity
            st.priority[idx.to(self.device)] = torch.as_tensor(
                np.asarray(data["leaf_priority"], np.float32)[-n:]).to(
                self.device)
            base = float(data.get("max_priority_base", 1.0))
            st.max_priority.fill_(float(np.float32(
                base ** self.alpha if self.alpha else base)))
        return n

    def beta(self, step: int) -> float:
        frac = min(1.0, step / max(1, self.beta_steps))
        return self.beta0 + (1.0 - self.beta0) * frac

    def build_fused_step(self, train_step, batch_size: int,
                         steps_per_call: int = 1, megabatch: int = 1,
                         megabatch_step=None,
                         sample_fn: Callable = hierarchical_sample):
        """``fused(ts, rs, us (K, B), beta) -> (ts', metrics)``: K sub-steps
        of sample -> train -> write-back on the ring state ``rs`` (updated
        in place); ``beta`` is a float or a () tensor.  Metrics are the last
        sub-step's, except ``learner/skipped``, which sums over the K
        sub-steps.  ``megabatch`` M > 1 (with ``megabatch_step`` from
        ``factory.build_megabatch_train_step``) runs K/M groups of M, each
        on the uniforms the sequential schedule would give its M
        minibatches (rows g*M .. g*M + M - 1 of ``us``)."""
        alpha, K, M = self.alpha, steps_per_call, megabatch
        if M > 1:
            if megabatch_step is None:
                raise ValueError("megabatch > 1 needs the factory's "
                                 "megabatch step")
            if K % M:
                raise ValueError(f"megabatch {M} must divide "
                                 f"steps_per_call {K}")

        def fused(ts, rs: PerReplayState, us: torch.Tensor, beta):
            if tuple(us.shape) != (K, batch_size):
                raise ValueError(f"uniforms {tuple(us.shape)}, expected "
                                 f"({K}, {batch_size})")
            skipped = None
            if M > 1:
                for g in range(K // M):
                    batch = per_sample(rs, us[g * M:(g + 1) * M].reshape(-1),
                                       beta, sample_fn)
                    batches = group_batches(batch, M)
                    ts, metrics, td_abs, ok = megabatch_step(ts, batches)
                    for m in range(M):
                        per_update_priorities(rs, batches.index[m],
                                              td_abs[m], alpha, 1.0 - ok[m])
                    skipped = sum_skipped(metrics, skipped)
            else:
                for k in range(K):
                    batch = per_sample(rs, us[k], beta, sample_fn)
                    ts, metrics, td_abs = train_step(ts, batch)
                    per_update_priorities(rs, batch.index, td_abs, alpha,
                                          metrics.get(SKIPPED_KEY))
                    skipped = sum_skipped(metrics, skipped)
            if skipped is not None:
                metrics = dict(metrics, **{SKIPPED_KEY: skipped})
            return ts, metrics

        return fused


def _copy_tree_(dst, src) -> None:
    """Copy every tensor of ``src`` into the same place of ``dst``."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_tree_(dst[k], src[k])
    else:
        for d, s_ in zip(dst, src):
            _copy_tree_(d, s_)


def _clone_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return type(tree)(*(_clone_tree(v) for v in tree))


class GraphedFusedStep:
    """A fused step (``build_fused_step`` of the PER ring or of the uniform
    ring, whose ``beta`` is None) replayed from a CUDA graph, with the
    same call: ``(ts, rs, us (K, B), beta) -> (ts', metrics)``.

    The first ``warmup`` calls run the step eagerly on a side stream (lazy
    initialisation must not happen under capture); the next call copies
    its train state into static buffers, captures one step that reads
    those buffers and writes its result back into them, and replays it.
    From then on a call copies the uniforms and ``beta`` into their static
    buffers and replays: every call is exactly one real update of ``rs``
    (which must be the ring the graph was captured on; its tensors are
    updated in place, so ingest between calls is seen) and of the train
    state.  The returned train state and metrics are the static buffers,
    overwritten by the next call.

    ``counters`` are the kernel wrappers whose ``launches`` count the
    kernels they launch: capture records their launches without running
    them, so the counts are put back after capture, and each replay adds
    the launches the captured step holds."""

    def __init__(self, fused: Callable, ring: ReplayState,
                 counters: Sequence = (), warmup: int = 2):
        self._fused = fused
        self._ring = ring
        self._counters = tuple(counters)
        self._warmup = warmup
        self._graph = None
        self._deltas = ()
        self._static = self._metrics = self._us = self._beta = None

    def _eager(self, ts, us, beta):
        cur = torch.cuda.current_stream(us.device)
        side = torch.cuda.Stream(us.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self._fused(ts, self._ring, us, beta)
        cur.wait_stream(side)
        torch.cuda.synchronize(us.device)  # no side-stream block outlives
        return out

    def _capture(self, ts, us, beta) -> None:
        self._static = _clone_tree(ts)
        self._us = us.clone()
        self._beta = (None if beta is None
                      else torch.full((), float(beta), device=us.device))
        before = [c.launches for c in self._counters]
        graph = torch.cuda.CUDAGraph()
        # thread_local: actor threads go on launching work on their own
        # streams and synchronising with it while this thread captures
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            new_ts, self._metrics = self._fused(self._static, self._ring,
                                                self._us, self._beta)
            _copy_tree_(self._static, new_ts)
        self._deltas = tuple(c.launches - b
                             for c, b in zip(self._counters, before))
        for c, b in zip(self._counters, before):
            c.launches = b
        self._graph = graph

    def __call__(self, ts, rs: ReplayState, us: torch.Tensor, beta=None):
        if rs is not self._ring:
            raise ValueError("the graph replays the ring it was captured on")
        if self._warmup > 0:
            self._warmup -= 1
            return self._eager(ts, us, beta)
        if self._graph is None:
            self._capture(ts, us, beta)
        else:
            if ts is not self._static:
                _copy_tree_(self._static, ts)
            self._us.copy_(us)
            if self._beta is not None:
                self._beta.fill_(float(beta))
        self._graph.replay()
        for c, d in zip(self._counters, self._deltas):
            c.launches += d
        return self._static, self._metrics
