"""Shared inference server (``actor_backend=batched``) — the port of
pytorch_distributed_tpu/agents/inference.py (:1-477): ``InferenceClient``
(:55-144) and ``InferenceServer`` (:147-477) for the dqn and DDPG
families.

Actor processes hold no model.  Each tick an actor sends its observations,
its epsilons and the tick's explore uniforms and random actions (drawn
from its own generator, agents/actor.py) to an ``InferenceServer`` thread
in the learner's process, which owns the card; the server runs the
forward and sends back one packed ``(3, N)`` array of (action, q_sel,
q_max).  A row's action depends on its own arguments only, so a batched
actor's transition stream is the inline stream, however rows are batched.
What batching changes is the weights' staleness: the server refreshes
from the ``ParamStore`` at most once every ``sync_secs`` (1 s, as the
reference), not on each actor's ``actor_sync_freq`` cadence.

Requests: when every row of a uint8 frame stack rolled by one frame since
the client's last request (``obs[:, :-1] == prev[:, 1:]``), only the
newest frame crosses (``packed``), and the server rolls the client's
resident stack (``models/policies.packed_roll_act``); otherwise (the first
tick, any reset) the whole stack does (``full``), and it reseeds that
stack.  The server waits for any request, then takes every one already
waiting (no batching window), up to ``MAX_BATCH`` rows a sweep.  Packed
requests run one program each, all launched before any is waited on;
full requests of one client run as they are, and those of several run as
one forward over their rows, padded to a power of two, and are split
back.

Where the port differs from the reference:

- The carrier, on the process backend, is one request pipe and one
  response pipe per actor slot, and a fresh pair for each incarnation
  (``replace_client``); the server waits on every slot's reader.  The
  reference shares one request ``multiprocessing.Queue``, whose
  cross-process locks an actor SIGKILLed inside a put or a get leaves
  held (memory/device_replay.py found the same on the ingest queue).  A
  client's nonce stays as the second guard.  On the thread backend,
  in-process queues serve.
- On a GPU the server's device work runs on a high-priority CUDA stream
  of its own, so a request never waits behind the learner's queued graph
  replays.  Every program is replayed from a CUDA graph with static
  inputs and static weights, the counterpart of the reference's jit per
  shape: one roll-act graph per client and one rows graph per row count
  (a client's, and each power of two up to the widest sweep).  The
  graphs are captured in the serve thread while ``start`` waits, before
  the learner's loop runs, since a device-wide synchronize in another
  thread would break a capture.  Uploads come from pinned staging, each
  response's device-to-host copy is marked by an event, and a refresh
  copies the new weights into the static ones on the same stream.  On
  the CPU the programs run eagerly.  A graph that fails to capture
  raises; nothing falls back to the eager path or to the CPU.

For DDPG (reference :263-267) a request carries the observations alone
and the response is the policy's deterministic actions, (N, d) float32:
the rows program is the actor's forward (``models/policies.ddpg_act``),
the low-dim observations are never frame-packed, so there is no roll-act
program, and the OU noise stays with the actor (agents/actor.py).

A crash of the serve loop is recorded as ``server-crash`` in the
``inference`` flight recorder (reference :383-386) before every client
is refused; the runtime's monitor dumps it when it stops the run.

The perf plane (utils/perf.py, reference :189-195, :280-283, :317-334,
:358, :397): the ``inference`` monitor counts the rows served (its
``inference/env_frames_per_s``) and watches the server's CUDA graphs for
recaptures (``captures``); with the plane on, the serve thread anchors
it once the programs are built, drains it into ``scalars.jsonl`` (role
``inference``) every 15 s and once more when it stops.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import threading
import time
from multiprocessing import connection
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch.agents.param_store import (
    ParamStore, unflatten_into,
)
from pytorch_distributed_tpu_torch.config import Options
from pytorch_distributed_tpu_torch.factory import (
    EnvSpec, build_model, module_apply, resolve_device, state_dtype,
)
from pytorch_distributed_tpu_torch.models.policies import (
    ddpg_act, packed_act_rows, packed_roll_act,
)
from pytorch_distributed_tpu_torch.utils import flight_recorder, perf
from pytorch_distributed_tpu_torch.utils.metrics import MetricsWriter

_CTX = mp.get_context("spawn")

# a response's payload when the server failed: the client raises
_ERROR = "__inference_error__"

STAT_KEYS = ("requests", "batches", "rows", "widest_batch",
             "param_refreshes", "forwards", "packed")
MAX_BATCH = 1024  # rows a sweep takes at most (the reference's)


def _send(end, msg) -> None:
    if isinstance(end, queue.Queue):
        end.put(msg)
    else:
        end.send(msg)


def _recv(end, timeout: float):
    """One message from a pipe or an in-process queue; ``queue.Empty``
    when none came within ``timeout``."""
    if isinstance(end, queue.Queue):
        return end.get(timeout=max(timeout, 0.0))
    if not end.poll(max(timeout, 0.0)):
        raise queue.Empty
    return end.recv()


_F_SETPIPE_SZ = 1031  # fcntl.F_SETPIPE_SZ on Linux
_REQUEST_PIPE_BYTES = 1 << 20


def _widen_pipe(conn) -> None:
    """Give a request pipe room for a whole full stack (451 KB at config
    12), so an actor's send returns without waiting for the serve thread
    to read; where the host refuses, the pipe keeps its default 64 KB."""
    try:
        import fcntl

        fcntl.fcntl(conn.fileno(), _F_SETPIPE_SZ, _REQUEST_PIPE_BYTES)
    except (ImportError, OSError):
        pass


class InferenceClient:
    """An actor's handle on the server: one request in flight.  It rides
    the actor's arguments into a spawn child; ``begin_session`` is called
    in the actor before its first ``submit``."""

    def __init__(self, client_id: int, req, resp):
        self.client_id = client_id
        self._req = req    # a pipe's write end, or the server's queue
        self._resp = resp  # a pipe's read end, or this client's queue
        self._nonce = 0
        self._eps: Optional[np.ndarray] = None
        self._prev_obs: Optional[np.ndarray] = None

    def begin_session(self, eps=None) -> None:
        """A fresh incarnation: stamp a nonce, bind the per-env epsilons
        (sent with every request, so the server keeps no client state but
        the frame stack; None for DDPG) and drop any response already
        waiting."""
        self._nonce = int(time.monotonic_ns() & 0x7FFFFFFF) or 1
        self._eps = None if eps is None else np.asarray(eps, np.float32)
        self._prev_obs = None  # the first request reseeds the stack
        while True:
            try:
                _recv(self._resp, 0.0)
            except (queue.Empty, EOFError, OSError):
                break

    def submit(self, obs: np.ndarray, tick: int,
               explore_u: Optional[np.ndarray] = None,
               random_a: Optional[np.ndarray] = None) -> int:
        """Send this tick's observations with its explore uniforms and
        random actions (none for DDPG), frame-packed when every row rolled
        by one frame since the last request.  Returns the handle
        ``collect`` takes."""
        obs = np.ascontiguousarray(obs)
        prev = self._prev_obs
        mode, payload = "full", obs
        if (obs.dtype == np.uint8 and obs.ndim >= 3 and obs.shape[1] > 1
                and prev is not None and prev.shape == obs.shape
                and np.array_equal(obs[:, :-1], prev[:, 1:])):
            mode, payload = "packed", np.ascontiguousarray(obs[:, -1])
        self._prev_obs = obs
        if explore_u is not None:
            explore_u = np.asarray(explore_u, np.float32)
            random_a = np.asarray(random_a, np.int64)
        _send(self._req, (self.client_id, self._nonce, int(tick), mode,
                          payload, self._eps, explore_u, random_a))
        return int(tick)

    def collect(self, handle: int, timeout: float = 300.0) -> np.ndarray:
        """The packed ``(3, N)`` response to ``handle`` (DDPG: the (N, d)
        actions).  A response of an
        older incarnation is dropped; the server's error raises
        ``RuntimeError``; no response within ``timeout`` raises
        ``TimeoutError``."""
        deadline = time.monotonic() + timeout
        while True:
            remain = deadline - time.monotonic()
            if remain <= 0:
                raise TimeoutError(
                    f"inference client {self.client_id}: no response for "
                    f"tick {handle} within {timeout} s (server dead?)")
            try:
                nonce, tick, payload = _recv(self._resp, remain)
            except queue.Empty:
                continue
            except (EOFError, OSError) as e:
                raise RuntimeError(f"inference client {self.client_id}: "
                                   f"the server closed its pipe") from e
            if isinstance(payload, tuple) and payload[:1] == (_ERROR,):
                raise RuntimeError(f"inference server failed: {payload[1]}")
            if nonce != self._nonce:
                continue  # a dead incarnation's leftover
            if tick != handle:
                raise RuntimeError(
                    f"inference client {self.client_id}: got tick {tick}, "
                    f"expected {handle}")
            return payload

    def close(self) -> None:
        """Close this process's pipe ends (no-op for in-process queues)."""
        for end in (self._req, self._resp):
            if not isinstance(end, queue.Queue):
                end.close()


class _Link:
    """The server's side of one client incarnation."""

    def __init__(self, slot: int, req, resp, client: InferenceClient):
        self.slot, self.req, self.resp = slot, req, resp
        self.client = client
        self.dead = False


class _Program:
    """One act program at a fixed row count: static inputs on the run's
    device (``dev``) that ``launch`` fills from host arrays and then runs
    ``fn(**dev)``, whose output is ``out_shape`` fp32.  On a GPU the
    inputs are uploaded from pinned staging,
    ``fn`` is replayed from a CUDA graph on the server's stream, and the
    packed output comes back by a non-blocking copy that an event marks;
    ``result`` waits for the event.  On the CPU ``fn`` runs eagerly."""

    def __init__(self, fn: Callable, inputs: Dict[str, Tuple[tuple, Any]],
                 rows: int, device: torch.device, stream,
                 out_shape: Optional[tuple] = None):
        self.rows = rows
        self._fn, self._stream = fn, stream
        self.graph = None
        self.out: Optional[torch.Tensor] = None
        with torch.cuda.stream(stream):  # a no-op for None
            self.dev = {k: torch.zeros(s, dtype=d, device=device)
                        for k, (s, d) in inputs.items()}
        if device.type != "cuda":
            return
        self.host = {k: torch.zeros(s, dtype=d, pin_memory=True)
                     for k, (s, d) in inputs.items()}
        self.out_host = torch.zeros(out_shape or (3, rows),
                                    pin_memory=True)
        self.done = torch.cuda.Event()
        with torch.cuda.stream(stream):
            for _ in range(2):  # cuDNN's plans and lazy set-up, uncaptured
                fn(**self.dev)
            stream.synchronize()
            graph = torch.cuda.CUDAGraph()
            # the capture goes on the server's stream (never the process's
            # shared default capture stream, which the learner's capture
            # may hold); thread_local, so other threads go on launching
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.out = fn(**self.dev)
            finally:
                graph.capture_end()
        self.graph = graph

    def stage(self, name: str, lo: int, hi: int, value) -> None:
        """Write ``value`` into rows ``lo:hi`` of input ``name`` (into its
        pinned staging on a GPU, to be uploaded by ``launch``)."""
        dst = (self.host if self.graph is not None else self.dev)[name]
        if name == "ctl":
            dst.numpy()[:, lo:hi] = value
        else:
            dst.numpy()[lo:hi] = value

    def launch(self, names: Tuple[str, ...]) -> None:
        """Upload the staged inputs ``names`` and run the program."""
        if self.graph is None:
            self.out = self._fn(**self.dev)
            return
        with torch.cuda.stream(self._stream):
            for k in names:
                self.dev[k].copy_(self.host[k], non_blocking=True)
            self.graph.replay()
            self.out_host.copy_(self.out, non_blocking=True)
            self.done.record(self._stream)

    def result(self) -> np.ndarray:
        if self.graph is None:
            return self.out.numpy()
        self.done.synchronize()
        return self.out_host.numpy()


class InferenceServer:
    """The batching forward server: one thread in the process that owns
    the run's device (``runtime.Topology`` starts it after the workers and
    stops it after their join).  ``stats`` counts requests, sweeps
    (``batches``), rows, the widest sweep, weight refreshes, forwards and
    frame-packed requests."""

    def __init__(self, opt: Options, spec: EnvSpec, param_store: ParamStore,
                 in_process: bool = False, sync_secs: float = 1.0):
        if opt.agent_type not in ("dqn", "ddpg"):
            raise NotImplementedError(
                f"the inference server serves the dqn and ddpg families, "
                f"not {opt.agent_type!r}")
        self.opt, self.spec = opt, spec
        # DDPG: the policy's actions, no explore arguments, no frame stacks
        self._ddpg = opt.agent_type == "ddpg"
        # the rows programs take the run's observations as they come:
        # uint8 frame stacks, or the low-dim rows' float32 states (which
        # are never frame-packed)
        self.obs_dtype = torch.from_numpy(
            np.zeros(0, dtype=state_dtype(opt))).dtype
        self.param_store = param_store
        self.device = resolve_device(opt)
        self.sync_secs = sync_secs
        self.rows_per_client = max(1, opt.env_params.num_envs_per_actor)
        self._in_process = in_process
        self._requests: Optional[queue.Queue] = (
            queue.Queue() if in_process else None)
        self._lock = threading.Lock()  # the link table: serve vs monitor
        self._links: Dict[int, _Link] = {}
        self._retired: List[_Link] = []
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None
        self.stats = dict.fromkeys(STAT_KEYS, 0)
        self._version = 0
        self._last_sync = 0.0
        self._params: Optional[Dict[str, torch.Tensor]] = None
        self._rows_progs: Dict[int, _Program] = {}
        self._roll_progs: Dict[int, _Program] = {}
        self.perf = perf.get_monitor("inference", opt.perf_params)
        self.perf.register_jit("inference", lambda: self.captures)

    @property
    def captures(self) -> int:
        """The CUDA graphs captured (one a program on a GPU, none on the
        CPU)."""
        progs = (*self._rows_progs.values(), *self._roll_progs.values())
        return sum(p.graph is not None for p in progs)

    # -- wiring (in the learner's process, before and while workers run) ---

    def _new_link(self, slot: int) -> _Link:
        if self._in_process:
            resp: queue.Queue = queue.Queue()
            client = InferenceClient(slot, self._requests, resp)
            return _Link(slot, None, resp, client)
        req_r, req_w = _CTX.Pipe(duplex=False)
        _widen_pipe(req_w)
        resp_r, resp_w = _CTX.Pipe(duplex=False)
        return _Link(slot, req_r, resp_w, InferenceClient(slot, req_w,
                                                          resp_r))

    def make_client(self, slot: int) -> InferenceClient:
        """The client of actor slot ``slot``."""
        with self._lock:
            if slot not in self._links:
                self._links[slot] = self._new_link(slot)
            return self._links[slot].client

    def replace_client(self, slot: int) -> InferenceClient:
        """A fresh request/response pair for the respawn of ``slot``; the
        old pair is closed by the serve thread."""
        with self._lock:
            old = self._links.pop(slot, None)
            if old is not None:
                old.dead = True
                self._retired.append(old)
            self._links[slot] = self._new_link(slot)
            return self._links[slot].client

    def close_client_ends(self, slot: int) -> None:
        """Drop this process's copies of ``slot``'s client ends once its
        actor holds its own, so a dead actor's pipes end in EOF here."""
        with self._lock:
            self._links[slot].client.close()

    def start(self) -> None:
        """Start the serve thread and wait until it has built its programs
        (on a GPU: captured every graph); raises if the build failed."""
        self._thread = threading.Thread(target=self._serve,
                                        name="inference-server",
                                        daemon=True)
        self._thread.start()
        while not self._ready.wait(0.05):
            if self.error is not None or not self._thread.is_alive():
                raise RuntimeError("the inference server failed to build") \
                    from self.error

    def stop(self) -> None:
        self._stop.set()
        if self._requests is not None:
            self._requests.put(None)  # wakes the blocking get
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        with self._lock:
            links = list(self._links.values()) + self._retired
            self._retired = []
        for link in links:
            self._close_link(link)

    def healthy(self) -> bool:
        """False once the serve thread failed (the runtime's monitor stops
        the run on it)."""
        if self._stop.is_set() or self._thread is None:
            return True
        return self.error is None and self._thread.is_alive()

    # -- programs ----------------------------------------------------------

    def _build(self) -> None:
        """The model, the static weights and the programs, in the serve
        thread.  On a GPU every program this topology can need is built
        (and captured) here: each client's roll-act, the rows program at a
        client's width and at every power of two up to the widest sweep."""
        dev = self.device
        self._stream = (torch.cuda.Stream(dev, priority=-1)
                        if dev.type == "cuda" else None)
        model = build_model(self.opt, self.spec, init_weights=False)
        self._apply = module_apply(model)
        with torch.cuda.stream(self._stream):  # a no-op for None
            self._params = {k: torch.zeros_like(v, device=dev)
                            for k, v in model.state_dict().items()}
            self._flat_dev = torch.zeros(sum(v.numel() for v in
                                             self._params.values()),
                                         device=dev)
        if dev.type != "cuda":
            return
        self._flat_host = torch.zeros(self._flat_dev.numel(),
                                      pin_memory=True)
        self._refreshed = torch.cuda.Event()
        self._refreshed.record(self._stream)
        n = self.rows_per_client
        with self._lock:
            slots = sorted(self._links)
        widest = min(MAX_BATCH, max(1, len(slots)) * n)
        sizes = {n}
        p = 1
        while p < widest:
            p *= 2
            if p > n:
                sizes.add(p)
        for rows in sorted(sizes):
            self._rows_program(rows)
        if self._ddpg:
            return
        for slot in slots:
            self._roll_program(slot, n)

    def _rows_program(self, rows: int) -> _Program:
        prog = self._rows_progs.get(rows)
        if prog is None:
            self._check_unbuilt(f"a rows program of {rows} rows")
            apply, params = self._apply, self._params
            obs = ((rows, *self.spec.state_shape), self.obs_dtype)
            if self._ddpg:
                prog = _Program(lambda obs: ddpg_act(apply, params, obs),
                                {"obs": obs}, rows, self.device,
                                self._stream,
                                out_shape=(rows, self.spec.action_dim))
                self._rows_progs[rows] = prog
                return prog
            prog = _Program(
                lambda obs, ctl: packed_act_rows(apply, params, obs, ctl[0],
                                                 ctl[1], ctl[2].long()),
                {"obs": ((rows, *self.spec.state_shape), self.obs_dtype),
                 "ctl": ((3, rows), torch.float32)},
                rows, self.device, self._stream)
            self._rows_progs[rows] = prog
        return prog

    def _roll_program(self, slot: int, rows: int) -> _Program:
        prog = self._roll_progs.get(slot)
        if prog is None:
            self._check_unbuilt(f"a roll-act program for client {slot}")
            apply, params = self._apply, self._params
            prog = _Program(
                lambda stack, new, ctl: packed_roll_act(
                    apply, params, stack, new, ctl[0], ctl[1],
                    ctl[2].long())[1],
                {"stack": ((rows, *self.spec.state_shape), torch.uint8),
                 "new": ((rows, *self.spec.state_shape[1:]), torch.uint8),
                 "ctl": ((3, rows), torch.float32)},
                rows, self.device, self._stream)
            self._roll_progs[slot] = prog
        if prog.rows != rows:
            raise ValueError(f"client {slot} sent {rows} rows; its stack "
                             f"holds {prog.rows}")
        return prog

    def _check_unbuilt(self, what: str) -> None:
        # on a GPU a capture now could overlap the learner's loop
        if self.device.type == "cuda" and self._ready.is_set():
            raise RuntimeError(f"{what} was not built at start (the "
                               f"server serves {self.rows_per_client} rows "
                               f"a client, up to {MAX_BATCH} a sweep)")

    def _refresh_params(self, block: bool) -> None:
        """Copy the newest published weights into the static ones: blocking
        only before the first request, then at most once every
        ``sync_secs``.  On a GPU the copies go on the server's stream,
        ahead of the programs that read them."""
        now = time.monotonic()
        if self._version > 0:
            if (now - self._last_sync < self.sync_secs
                    or self.param_store.version <= self._version):
                return
            got = self.param_store.fetch(self._version)
        else:
            got = self.param_store.wait(0, timeout=300.0,
                                        stop=self._stop) if block else None
        if got is None:
            return
        flat, version = got
        shape = self.spec.state_shape
        if self._stream is None:
            unflatten_into(torch.from_numpy(flat), self._params, shape)
        else:
            self._refreshed.synchronize()  # the last upload left staging
            self._flat_host.numpy()[:] = flat
            with torch.cuda.stream(self._stream):
                self._flat_dev.copy_(self._flat_host, non_blocking=True)
                unflatten_into(self._flat_dev, self._params, shape)
                self._refreshed.record(self._stream)
        self._version = version
        self._last_sync = now
        self.stats["param_refreshes"] += 1

    # -- the serve loop ----------------------------------------------------

    def _close_link(self, link: _Link) -> None:
        link.dead = True
        if not self._in_process:
            for end in (link.req, link.resp):
                end.close()

    def _gather(self, timeout: float) -> List[Tuple[_Link, tuple]]:
        """Wait up to ``timeout`` for a request, then take every request
        already waiting."""
        if self._in_process:
            try:
                first = self._requests.get(timeout=timeout)
            except queue.Empty:
                return []
            got = [first]
            while True:
                try:
                    got.append(self._requests.get_nowait())
                except queue.Empty:
                    break
            with self._lock:
                return [(self._links[r[0]], r) for r in got
                        if r is not None]
        with self._lock:
            for link in self._retired:
                self._close_link(link)
            self._retired = []
            live = {link.req: link for link in self._links.values()
                    if not link.dead}
        out = []
        for conn in connection.wait(list(live), timeout):
            link = live[conn]
            try:
                out.append((link, conn.recv()))
            except (EOFError, OSError):
                # the actor died (maybe inside a send); its respawn gets
                # a fresh pair
                link.dead = True
        return out

    def _respond(self, link: _Link, msg) -> None:
        if link.dead and not self._in_process:
            return
        try:
            _send(link.resp, msg)
        except (BrokenPipeError, EOFError, OSError):
            link.dead = True  # the actor is gone

    def _serve(self) -> None:
        writer = None
        last_drain = time.monotonic()
        try:
            self._build()
            if self.perf.enabled:
                # the server has no stats cadence of its own: its thread
                # drains the monitor every 15 s
                writer = MetricsWriter(self.opt.log_dir,
                                       enable_tensorboard=False,
                                       role="inference", run_id=self.opt.refs)
                self.perf.drain()  # the window starts after the build
            self._ready.set()
            while not self._stop.is_set():
                if writer is not None \
                        and time.monotonic() - last_drain >= 15.0:
                    last_drain = time.monotonic()
                    writer.scalars(self.perf.drain(), step=0)
                got = self._gather(0.2)
                if not got:
                    continue
                self._refresh_params(block=True)
                rows = 0
                sweep: List[Tuple[_Link, tuple]] = []
                for item in got:
                    n = len(item[1][4])
                    if sweep and rows + n > MAX_BATCH:
                        self._run_sweep(sweep, rows)
                        sweep, rows = [], 0
                    sweep.append(item)
                    rows += n
                self._run_sweep(sweep, rows)
        except BaseException as e:  # noqa: BLE001 - told to every client
            if self._stop.is_set():
                return  # shutdown race (an interrupted weight wait)
            self.error = e
            flight_recorder.get_recorder("inference").record(
                "server-crash", error=repr(e))
            self._refuse_until_stopped((0, 0, (_ERROR, repr(e))))
            raise
        finally:
            if writer is not None:
                writer.scalars(self.perf.drain(), step=0)
                writer.close()

    def _refuse_until_stopped(self, err) -> None:
        """After a failure: tell every client, then answer every request
        with the error until ``stop``, so no actor waits out ``collect``'s
        timeout on a server that will not serve (the monitor stops the
        run on ``healthy()``)."""
        with self._lock:
            links = list(self._links.values())
        for link in links:
            self._respond(link, err)
        while not self._stop.is_set():
            for link, _req in self._gather(0.2):
                self._respond(link, err)

    def _run_sweep(self, sweep: List[Tuple[_Link, tuple]],
                   rows: int) -> None:
        """Launch every program of one sweep, then wait for each in turn
        and answer its clients."""
        st = self.stats
        st["requests"] += len(sweep)
        st["batches"] += 1
        st["rows"] += rows
        self.perf.note_frames(rows)
        st["widest_batch"] = max(st["widest_batch"], rows)
        launched: List[Tuple[_Program, list]] = []
        for link, req in sweep:
            if req[3] == "packed":
                _cid, _nonce, _tick, _m, new, eps, u, a = req
                prog = self._roll_program(link.slot, len(new))
                prog.stage("new", 0, len(new), new)
                prog.stage("ctl", 0, len(new), np.stack([eps, u, a]))
                prog.launch(("new", "ctl"))
                launched.append((prog, [(link, req, 0, len(new))]))
                st["packed"] += 1
        full = [(link, req) for link, req in sweep if req[3] == "full"]
        if full:
            launched.append(self._launch_full(full))
        for prog, parts in launched:
            out = prog.result()
            for link, req, lo, hi in parts:
                part = out[lo:hi] if self._ddpg else out[:, lo:hi]
                self._respond(link, (req[1], req[2], np.array(part)))
        st["forwards"] += len(launched)

    def _launch_full(self, full: List[Tuple[_Link, tuple]]
                     ) -> Tuple[_Program, list]:
        """One forward over every full request's rows (one client's at its
        width, several padded to a power of two), and each client's stack
        reseeded from its rows."""
        sizes = [len(req[4]) for _link, req in full]
        total = sum(sizes)
        rows = total
        if len(full) > 1:
            rows = 1
            while rows < total:
                rows *= 2
        prog = self._rows_program(rows)
        parts, lo = [], 0
        for (link, req), n in zip(full, sizes):
            _cid, _nonce, _tick, _m, obs, eps, u, a = req
            prog.stage("obs", lo, lo + n, obs)
            if not self._ddpg:
                prog.stage("ctl", lo, lo + n, np.stack([eps, u, a]))
            parts.append((link, req, lo, lo + n))
            lo += n
        if self._ddpg:
            prog.launch(("obs",))
            return prog, parts
        prog.launch(("obs", "ctl"))
        with torch.cuda.stream(self._stream):
            for link, _req, lo, hi in parts:
                self._roll_program(link.slot, hi - lo).dev["stack"].copy_(
                    prog.dev["obs"][lo:hi])
        return prog, parts
