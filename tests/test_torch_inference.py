"""The shared inference server (agents/inference.py, ``actor_backend=
batched``) and its acts (models/policies.py ``packed_roll_act``,
``packed_act_rows``), held to the reference's contracts
(tests/test_actor_pipeline.py:178-330) on the CPU:

- a batched actor's transition stream equals the inline stream to the
  bit, over the process backend's pipes and over in-process queues, with
  one client and with two whose requests share every sweep;
- the client's frame-packed or full choice equals the JAX
  ``InferenceClient.submit``'s on the same observations, resets included;
- ``packed_roll_act``'s new stack equals the JAX ``build_packed_roll_act``'s
  to the bit, and its greedy Q values (and ``packed_act_rows``'s) match
  the JAX programs' on converted weights, fp32, rtol 1e-4 / atol 1e-5;
- a stale nonce's response is dropped, the server's error raises
  ``RuntimeError``, a short timeout ``TimeoutError``;
- the server refreshes its weights from the store on its throttle;
- a failed build makes ``start`` raise, and a client that asks anyway
  gets the error instead of a wait;
- ``resolve_actor_backend`` falls back to ``pipelined`` without a client,
  with the reference's warning; a server on a device the host lacks
  raises."""

import multiprocessing as mp
import queue
import threading
import time

import numpy as np
import pytest
import torch

import jax

from pytorch_distributed_tpu.agents.inference import (
    InferenceClient as JaxClient,
)
from pytorch_distributed_tpu.config import build_options as jax_options
from pytorch_distributed_tpu.factory import (
    EnvSpec as JaxEnvSpec, build_model as jax_build_model,
    init_params as jax_init_params,
)
from pytorch_distributed_tpu.models import policies as jax_policies
from pytorch_distributed_tpu_torch.agents import inference
from pytorch_distributed_tpu_torch.agents.actor import (
    bounded_actor_run, snapshot_store,
)
from pytorch_distributed_tpu_torch.agents.inference import (
    InferenceClient, InferenceServer,
)
from pytorch_distributed_tpu_torch.config import build_options
from pytorch_distributed_tpu_torch.convert import convert_dqn_cnn
from pytorch_distributed_tpu_torch.factory import (
    EnvSpec, build_env_vector, build_model, module_apply, probe_env,
    resolve_actor_backend,
)
from pytorch_distributed_tpu_torch.models import policies
from pytorch_distributed_tpu_torch.utils.experience import REPLAY_FIELDS

FRAME = (4, 44, 44)
ACTIONS = 6
TICKS = 60


def _opt(tmp_path, backend, **kw):
    kw.setdefault("actor_freq", 10 ** 9)  # no mid-run drain of the timer
    return build_options(12, device="cpu", num_actors=2,
                         num_envs_per_actor=2, root_dir=str(tmp_path),
                         refs=f"t_{backend}", actor_backend=backend,
                         early_stop=25, **kw)


def _assert_streams_equal(a, b):
    assert len(a) == len(b) > TICKS
    for t1, t2 in zip(a, b):
        for f in REPLAY_FIELDS:
            x, y = np.asarray(getattr(t1, f)), np.asarray(getattr(t2, f))
            assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.timeout(240)
@pytest.mark.parametrize("in_process", [False, True],
                         ids=["pipes", "in_process"])
def test_batched_stream_equals_inline(tmp_path, in_process):
    """Actor 1 of 2, 2 envs, 60 ticks; early_stop 25 resets every env at
    ticks 25 and 50, so full uploads reseed the server's stack mid-run."""
    opt_b = _opt(tmp_path, "batched")
    spec = probe_env(opt_b)
    server = InferenceServer(opt_b, spec, snapshot_store(opt_b, spec, 0),
                             in_process=in_process)
    client = server.make_client(1)
    server.start()
    try:
        batched = bounded_actor_run(opt_b, TICKS, spec=spec, process_ind=1,
                                    inference=client)
    finally:
        server.stop()
    inline = bounded_actor_run(_opt(tmp_path, "inline"), TICKS, spec=spec,
                               process_ind=1)
    _assert_streams_equal(inline["stream"], batched["stream"])
    st = server.stats
    # the pipelined schedule's first dispatch runs one tick ahead
    assert st["requests"] == TICKS + 1 and st["rows"] == 2 * (TICKS + 1)
    assert st["packed"] > 0 and st["requests"] - st["packed"] >= 3
    assert st["param_refreshes"] == 1 and st["forwards"] == st["requests"]
    t = batched["timer_ms"]
    assert t["actor/time_sync_calls"] == TICKS
    assert t["actor/time_dispatch_calls"] == TICKS + 1
    assert "actor/time_param_swap_calls" not in t  # the server's weights


class _Lockstep(InferenceServer):
    """Takes no sweep until every client has a request waiting (or a few
    seconds passed), so two actors in lockstep share every sweep."""

    def _gather(self, timeout):
        got = super()._gather(timeout)
        deadline = time.monotonic() + 5.0
        while got and len(got) < len(self._links) \
                and time.monotonic() < deadline:
            got += super()._gather(0.01)
        return got


@pytest.mark.timeout(240)
def test_two_coalesced_clients_stream_as_inline(tmp_path):
    """Actors 0 and 1 of 2 on threads, one client each, every request in
    a sweep with the other's: the first tick's and the resets' full
    uploads run as one 4-row forward.  Each stream equals its own inline
    run."""
    opt_b = _opt(tmp_path, "batched")
    spec = probe_env(opt_b)
    server = _Lockstep(opt_b, spec, snapshot_store(opt_b, spec, 0))
    clients = [server.make_client(i) for i in range(2)]
    server.start()
    runs, errors = {}, []

    def actor(i):
        try:
            runs[i] = bounded_actor_run(opt_b, TICKS, spec=spec,
                                        process_ind=i, inference=clients[i])
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=actor, args=(i,)) for i in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(200)
    finally:
        server.stop()
    assert not errors, errors
    st = server.stats
    assert st["batches"] == TICKS + 1 and st["requests"] == 2 * (TICKS + 1)
    assert st["widest_batch"] == 4
    # per sweep: two packed forwards, or one coalesced forward of two
    # full requests
    assert st["forwards"] == st["packed"] + (st["requests"]
                                             - st["packed"]) // 2
    for i in range(2):
        inline = bounded_actor_run(_opt(tmp_path, "inline"), TICKS,
                                   spec=spec, process_ind=i)
        _assert_streams_equal(inline["stream"], runs[i]["stream"])


class _Sent:
    def __init__(self):
        self.items = []

    def put(self, item):
        self.items.append(item)


def _observation_runs():
    """Pong frame stacks over 40 ticks of random actions with resets at
    ticks 12, 24 and 36 (early_stop 12), then the reference test's
    synthetic stacks."""
    opt = build_options(12, device="cpu", early_stop=12)
    env = build_env_vector(opt, 0, 3)
    rng = np.random.default_rng(2)
    seq = [env.reset()]
    for _ in range(40):
        seq.append(env.step(rng.integers(0, ACTIONS, 3))[0])
    obs0 = np.arange(2 * 4 * 3 * 3, dtype=np.uint8).reshape(2, 4, 3, 3)
    rolled = np.concatenate([obs0[:, 1:], np.full((2, 1, 3, 3), 7,
                                                  np.uint8)], axis=1)
    reset = np.zeros_like(obs0)
    rolled2 = np.concatenate([reset[:, 1:], np.full((2, 1, 3, 3), 9,
                                                    np.uint8)], axis=1)
    return [seq, [obs0, rolled, reset, rolled2]]


def test_packed_or_full_choice_equals_jax():
    for seq in _observation_runs():
        n = len(seq[0])
        ours = queue.Queue()
        c = InferenceClient(0, ours, queue.Queue())
        c.begin_session(np.zeros(n, np.float32))
        jsent = _Sent()
        jc = JaxClient(0, "dqn", jsent, queue.Queue())
        jc.begin_session(base_key=np.zeros(2, np.uint32),
                         eps=np.zeros(n, np.float32))
        for k, obs in enumerate(seq):
            c.submit(obs, k, np.zeros(n), np.zeros(n, np.int64))
            jc.submit(obs, k)
        sent = [ours.get_nowait() for _ in seq]
        modes = [r[3] for r in sent]
        assert modes == [r[3] for r in jsent.items]
        assert "packed" in modes and modes.count("full") >= 2
        for r, jr in zip(sent, jsent.items):
            assert r[4].dtype == jr[4].dtype
            np.testing.assert_array_equal(r[4], jr[4])


def _jax_and_port_models():
    jopt = jax_options(12, compute_dtype="float32")
    jspec = JaxEnvSpec(state_shape=FRAME, discrete=True,
                       num_actions=ACTIONS, action_dim=0, norm_val=255.0)
    jmodel = jax_build_model(jopt, jspec)
    jparams = jax_init_params(jopt, jspec, jmodel, seed=3)
    opt = build_options(12, device="cpu", compute_dtype="float32")
    apply_fn = module_apply(build_model(opt, EnvSpec(FRAME, ACTIONS,
                                                     255.0)))
    return jmodel, jparams, apply_fn, convert_dqn_cnn(
        jax.device_get(jparams), FRAME)


def test_packed_acts_match_jax():
    """Greedy (eps 0) on converted weights: the rolled stack bit-equal,
    actions equal, q_sel and q_max rtol 1e-4 / atol 1e-5."""
    jmodel, jparams, apply_fn, params = _jax_and_port_models()
    rng = np.random.default_rng(5)
    n = 8
    stack = rng.integers(0, 255, (n, *FRAME)).astype(np.uint8)
    new = rng.integers(0, 255, (n, *FRAME[1:])).astype(np.uint8)
    eps0 = np.zeros(n, np.float32)
    j_stack, j_out = jax_policies.build_packed_roll_act(jmodel.apply)(
        jparams, jax.numpy.asarray(stack), new, jax.random.PRNGKey(0), 0,
        eps0)
    t_stack = torch.from_numpy(stack.copy())
    got_stack, out = policies.packed_roll_act(
        apply_fn, params, t_stack, torch.from_numpy(new),
        torch.from_numpy(eps0), torch.rand(n),
        torch.randint(0, ACTIONS, (n,)))
    assert got_stack is t_stack  # rolled in place
    np.testing.assert_array_equal(got_stack.numpy(), np.asarray(j_stack))
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(j_out)[0])
    np.testing.assert_allclose(out[1:].numpy(), np.asarray(j_out)[1:],
                               rtol=1e-4, atol=1e-5)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(1),
                                                 i))(jax.numpy.arange(n))
    j_rows = jax_policies.build_packed_act_rowkeys(jmodel.apply)(
        jparams, stack, keys, eps0)
    rows = policies.packed_act_rows(
        apply_fn, params, torch.from_numpy(stack), torch.from_numpy(eps0),
        torch.rand(n), torch.randint(0, ACTIONS, (n,)))
    np.testing.assert_array_equal(rows[0].numpy(), np.asarray(j_rows)[0])
    np.testing.assert_allclose(rows[1:].numpy(), np.asarray(j_rows)[1:],
                               rtol=1e-4, atol=1e-5)
    # explore rows take their random action, whatever the batch holds
    u = torch.tensor([0.0, 0.9] * (n // 2))
    a = torch.arange(n) % ACTIONS
    mixed = policies.packed_act_rows(apply_fn, params,
                                     torch.from_numpy(stack),
                                     torch.full((n,), 0.5), u, a)
    expect = np.where(u.numpy() < 0.5, a.numpy(), np.asarray(j_rows)[0])
    np.testing.assert_array_equal(mixed[0].numpy(), expect)


def _pipe_pair():
    ctx = mp.get_context("spawn")
    req_r, req_w = ctx.Pipe(duplex=False)
    resp_r, resp_w = ctx.Pipe(duplex=False)
    return InferenceClient(0, req_w, resp_r), req_r, resp_w


@pytest.mark.parametrize("carrier", ["pipes", "in_process"])
def test_client_drops_stale_raises_errors_and_times_out(carrier):
    if carrier == "pipes":
        c, req, resp = _pipe_pair()
        send = resp.send
    else:
        req, resp = queue.Queue(), queue.Queue()
        c = InferenceClient(0, req, resp)
        send = resp.put
    send((7, 0, "left by a dead incarnation"))
    c.begin_session(np.zeros(2, np.float32))  # drops what was waiting
    obs = np.zeros((2, 4, 3, 3), np.uint8)
    h = c.submit(obs, 5, np.zeros(2), np.zeros(2, np.int64))
    got = req.recv() if carrier == "pipes" else req.get_nowait()
    nonce = got[1]
    answer = np.ones((3, 2), np.float32)
    send((nonce + 1, 5, np.zeros((3, 2), np.float32)))  # a stale nonce
    send((nonce, 5, answer))
    np.testing.assert_array_equal(c.collect(h, timeout=5.0), answer)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        c.collect(h, timeout=0.3)
    assert time.monotonic() - t0 < 3.0
    send((0, 0, (inference._ERROR, "RuntimeError('boom')")))
    with pytest.raises(RuntimeError, match="boom"):
        c.collect(h, timeout=5.0)


@pytest.mark.timeout(240)
def test_server_refreshes_weights_on_its_throttle(tmp_path):
    """A second snapshot reaches the server's forward once ``sync_secs``
    passed since its last refresh, and not before."""
    from pytorch_distributed_tpu_torch.agents.param_store import (
        make_flattener,
    )
    from pytorch_distributed_tpu_torch.factory import init_params

    opt = _opt(tmp_path, "batched")
    spec = probe_env(opt)
    store = snapshot_store(opt, spec, 0)
    server = InferenceServer(opt, spec, store, sync_secs=3600.0)
    c = server.make_client(0)
    server.start()
    rng = np.random.default_rng(0)
    obs = rng.integers(0, 255, (2, *spec.state_shape)).astype(np.uint8)
    zeros = (np.zeros(2), np.zeros(2, np.int64))
    try:
        c.begin_session(np.zeros(2, np.float32))
        first = c.collect(c.submit(obs, 1, *zeros), timeout=60.0)
        store.publish(make_flattener(init_params(opt, spec, seed=1),
                                     spec.state_shape)[0])
        early = c.collect(c.submit(obs, 2, *zeros), timeout=60.0)
        server.sync_secs = 0.0  # the throttle's time has passed
        late = c.collect(c.submit(obs, 3, *zeros), timeout=60.0)
    finally:
        server.stop()
    np.testing.assert_array_equal(first, early)
    assert not np.array_equal(first[2], late[2])
    assert server.stats["param_refreshes"] == 2


def test_resolve_actor_backend_downgrades(tmp_path):
    opt = _opt(tmp_path, "batched")
    with pytest.warns(UserWarning, match="no InferenceClient"):
        assert resolve_actor_backend(opt, None) == "pipelined"
    assert resolve_actor_backend(opt, object()) == "batched"
    assert resolve_actor_backend(_opt(tmp_path, "inline")) == "inline"
    # config 12 runs both device-env backends (tests/test_torch_anakin.py
    # holds their step-downs against the reference's)
    for backend in ("device", "anakin"):
        assert resolve_actor_backend(_opt(tmp_path, backend),
                                     object()) == backend
    bad = _opt(tmp_path, "pipelined")
    bad.env_params.actor_backend = "warp"
    with pytest.raises(ValueError, match="warp"):
        resolve_actor_backend(bad)


def test_server_never_moves_to_the_cpu(tmp_path):
    """A server asked for the card on a host without one raises instead
    of serving from the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the card is usable")
    opt = _opt(tmp_path, "batched")
    spec = probe_env(opt)
    opt.device = "cuda"
    with pytest.raises(RuntimeError, match="no GPU"):
        InferenceServer(opt, spec, snapshot_store(opt, spec, 0))


@pytest.mark.timeout(60)
def test_a_failed_build_makes_start_raise(tmp_path):
    opt = _opt(tmp_path, "batched")
    spec = probe_env(opt)
    server = InferenceServer(opt, spec, snapshot_store(opt, spec, 0))
    c = server.make_client(0)

    def broken():
        raise RuntimeError("no model today")

    server._build = broken
    try:
        with pytest.raises(RuntimeError, match="failed to build"):
            server.start()
        assert not server.healthy()
        # a client that asks anyway is told, not left waiting
        c.begin_session(np.zeros(2, np.float32))
        obs = np.zeros((2, *spec.state_shape), np.uint8)
        with pytest.raises(RuntimeError, match="no model today"):
            c.collect(c.submit(obs, 1, np.zeros(2), np.zeros(2, np.int64)),
                      timeout=10.0)
    finally:
        server.stop()
