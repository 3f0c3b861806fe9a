"""Versioned parameter publication — the port of
pytorch_distributed_tpu/agents/param_store.py (``ParamStore`` :35-102,
``ParamPrefetcher`` :104-206, ``make_flattener`` :209).

The learner writes its parameters as one flat fp32 vector into a shared
array of the spawn context, under a lock, and bumps a version counter: one
coherent snapshot per publish.  The evaluator polls ``fetch(min_version)``
on its cadence and unflattens into CPU tensors; an actor's
``ParamPrefetcher`` does the fetch and the unflatten on a thread of its
own, and the actor's tick only swaps in what it finished.
The thread backend uses the same store, so both backends publish one
format.

The vector's layout is the reference's: its ``ravel_pytree`` order over
the flax tree, each leaf in the flax layout (convert.py ``flax_leaves``),
so a vector published by either package reads the same.

On a GPU the learner publishes through ``DevicePublisher``, off its loop,
as the reference does on an accelerator (agents/learner.py:223-263,
``_publish_async``).
"""

from __future__ import annotations

import ctypes
import multiprocessing as mp
import sys
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch.convert import flax_leaves

_CTX = mp.get_context("spawn")

Params = Dict[str, torch.Tensor]


class ParamStore:
    """One published flat fp32 parameter snapshot and its version."""

    def __init__(self, num_params: int):
        self.num_params = num_params
        self._buf = _CTX.Array(ctypes.c_float, num_params, lock=False)
        self._version = _CTX.Value("l", 0, lock=False)
        self._lock = _CTX.Lock()

    @property
    def version(self) -> int:
        return self._version.value

    def publish(self, flat: np.ndarray) -> int:
        """Write one coherent snapshot; returns the new version."""
        flat = np.asarray(flat, dtype=np.float32).ravel()
        if flat.size != self.num_params:
            raise ValueError(f"{flat.size} params for a store of "
                             f"{self.num_params}")
        with self._lock:
            np.frombuffer(self._buf, np.float32)[:] = flat
            self._version.value += 1
            return self._version.value

    def fetch(self, min_version: int = 0
              ) -> Optional[Tuple[np.ndarray, int]]:
        """A copy of ``(flat, version)`` if newer than ``min_version``,
        else None (one integer read)."""
        if self._version.value <= min_version:
            return None
        with self._lock:
            return (np.frombuffer(self._buf, np.float32).copy(),
                    self._version.value)

    def wait(self, min_version: int = 0, timeout: float = 300.0,
             poll: float = 0.02, stop=None) -> Tuple[np.ndarray, int]:
        """Block until a snapshot newer than ``min_version`` exists."""
        deadline = time.monotonic() + timeout
        while True:
            got = self.fetch(min_version)
            if got is not None:
                return got
            if stop is not None and stop.is_set():
                raise RuntimeError("stopped while waiting for params")
            if time.monotonic() > deadline:
                raise TimeoutError(f"no params published within {timeout}s")
            time.sleep(poll)


class ParamPrefetcher:
    """The actors' weight refresh off their tick (reference :104-206).

    A thread polls the store's version every ``poll_secs``; when a newer
    snapshot is there it fetches it and runs ``unravel_fn`` on it, and
    parks the result for ``take()``, which swaps it out under a lock.
    After a refresh the thread rests ``refresh_secs``, so a learner that
    publishes several times a second does not keep a core unflattening
    snapshots the tick would drop.

    ``stream``: the CUDA stream the consumer computes on, for an actor
    that infers on a GPU.  ``unravel_fn`` then runs on a stream of the
    prefetcher's own (it does the host-to-device copies there) and an
    event follows it; ``take()`` makes ``stream`` wait on that event and
    marks every tensor as used on ``stream``, so the caching allocator
    reuses none of them before the consumer's work on them is done.

    A failing refresh is printed once and retried; the consumer keeps the
    version it last took."""

    def __init__(self, store: ParamStore, unravel_fn: Callable,
                 start_version: int = 0, poll_secs: float = 0.1,
                 refresh_secs: float = 0.5, stream=None):
        self._store = store
        self._unravel_fn = unravel_fn
        self._version = start_version
        self._poll_secs = poll_secs
        self._refresh_secs = refresh_secs
        self._consumer = stream
        self._stream = (torch.cuda.Stream(stream.device)
                        if stream is not None else None)
        self.failures = 0
        self._ready: Optional[Tuple[Any, int, Any]] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="param-prefetch", daemon=True)
        self._thread.start()

    def _load(self, flat: np.ndarray) -> Tuple[Any, Any]:
        if self._stream is None:
            return self._unravel_fn(flat), None
        with torch.cuda.stream(self._stream):
            tree = self._unravel_fn(flat)
            done = torch.cuda.Event()
            done.record(self._stream)
        return tree, done

    def _run(self) -> None:
        while not self._stop.is_set():
            wait = self._poll_secs
            try:
                got = (self._store.fetch(self._version)
                       if self._store.version > self._version else None)
                if got is not None:
                    flat, version = got
                    tree, done = self._load(flat)
                    with self._lock:
                        self._ready = (tree, version, done)
                        self._version = version
                    wait = max(self._poll_secs, self._refresh_secs)
            except Exception as e:  # noqa: BLE001 - the actor keeps acting
                self.failures += 1
                if self.failures == 1:
                    print(f"[param-prefetch] weight refresh failing ({e!r});"
                          f" the actor continues on version "
                          f"{self._version} and the refresh is retried",
                          file=sys.stderr, flush=True)
            self._stop.wait(wait)

    @property
    def version(self) -> int:
        """The newest version the thread has loaded (taken or not)."""
        return self._version

    def take(self) -> Optional[Tuple[Any, int]]:
        """The newest prefetched ``(params, version)``, or None — the only
        call on the consumer's tick."""
        with self._lock:
            got, self._ready = self._ready, None
        if got is None:
            return None
        tree, version, done = got
        if done is not None:
            self._consumer.wait_event(done)
            for t in tree.values():
                t.record_stream(self._consumer)
        return tree, version

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)


def num_params(params: Params) -> int:
    return sum(int(v.numel()) for v in params.values())


def flatten_into(params: Params, out: torch.Tensor,
                 state_shape: Sequence[int]) -> torch.Tensor:
    """Copy ``params`` into the flat vector ``out`` (on their device) in
    the reference's order and layout: one copy per leaf."""
    pos = 0
    for _name, leaf in flax_leaves(params, state_shape):
        n = leaf.numel()
        out[pos:pos + n].view(leaf.shape).copy_(leaf)
        pos += n
    if pos != out.numel():
        raise ValueError(f"{pos} params for a vector of {out.numel()}")
    return out


def unflatten_into(flat: torch.Tensor, params: Params,
                   state_shape: Sequence[int]) -> Params:
    """The inverse of ``flatten_into``: write the vector ``flat`` into the
    existing tensors ``params`` (on ``flat``'s device), one copy per
    leaf, through the flax-layout views."""
    pos = 0
    for _name, leaf in flax_leaves(params, state_shape):
        n = leaf.numel()
        leaf.copy_(flat[pos:pos + n].view(leaf.shape))
        pos += n
    if pos != flat.numel():
        raise ValueError(f"{pos} params for a vector of {flat.numel()}")
    return params


def make_flattener(params: Params, state_shape: Sequence[int]
                   ) -> Tuple[np.ndarray, Callable[[np.ndarray], Params]]:
    """``(flat0, unflatten)`` for the ``dqn-cnn`` state_dict ``params``:
    ``flat0`` is its vector as the reference's ``ravel_pytree`` lays it
    out, and ``unflatten(flat)`` turns any such vector into a new
    state_dict of fp32 CPU tensors, writing each leaf through the same
    flax-layout views ``flatten_into`` reads."""
    template = {k: v.detach().cpu().float() for k, v in params.items()}
    flat0 = flatten_into(template, torch.empty(num_params(template)),
                         state_shape).numpy()

    def unflatten(flat: np.ndarray) -> Params:
        return unflatten_into(
            torch.from_numpy(np.asarray(flat, dtype=np.float32)),
            {k: torch.empty_like(v) for k, v in template.items()},
            state_shape)

    return flat0, unflatten


class DevicePublisher:
    """Publication off the learner's loop on a GPU.  ``submit`` enqueues a
    copy of the parameters into one of two flat device buffers on the
    loop's stream and records an event; it never waits.  A background
    thread takes the newest submitted buffer, waits for its event on a
    stream of its own, copies it into a pinned host buffer and writes the
    shared store.  A buffer the thread is reading is never the target of
    a submit; a snapshot not yet taken is replaced by a newer one."""

    def __init__(self, store: ParamStore, state_shape: Sequence[int],
                 device: torch.device):
        self._store = store
        self._shape = tuple(state_shape)
        n = store.num_params
        self._bufs = [torch.empty(n, device=device) for _ in range(2)]
        self._events = [torch.cuda.Event() for _ in range(2)]
        self._host = torch.empty(n, pin_memory=True)
        self._stream = torch.cuda.Stream(device)
        self._cond = threading.Condition()
        self._pending: Optional[int] = None
        self._busy: Optional[int] = None
        self._closed = False
        self.published = 0
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, name="param-pub",
                                        daemon=True)
        self._thread.start()

    def submit(self, params: Params) -> None:
        with self._cond:
            if self.error is not None:
                raise RuntimeError("parameter publication failed") \
                    from self.error
            target = self._pending if self._pending is not None else 0
            if target == self._busy:
                target = 1 - target
            flatten_into(params, self._bufs[target], self._shape)
            self._events[target].record()
            self._pending = target
            self._cond.notify()

    def _run(self) -> None:
        while True:
            with self._cond:
                while self._pending is None and not self._closed:
                    self._cond.wait()
                if self._pending is None:
                    return
                self._busy, self._pending = self._pending, None
            try:
                with torch.cuda.stream(self._stream):
                    self._stream.wait_event(self._events[self._busy])
                    self._host.copy_(self._bufs[self._busy],
                                     non_blocking=True)
                self._stream.synchronize()
                self._store.publish(self._host.numpy())
                self.published += 1
            except BaseException as e:  # surfaced by the next submit
                self.error = e
                return
            finally:
                with self._cond:
                    self._busy = None

    def close(self) -> None:
        """Publish what is pending, then end the thread."""
        with self._cond:
            self._closed = True
            self._cond.notify()
        self._thread.join(timeout=60.0)
        if self.error is not None:
            raise RuntimeError("parameter publication failed") from self.error
