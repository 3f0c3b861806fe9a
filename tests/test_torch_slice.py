"""Slice 1 of the port as a whole (CONFIGS row 12, dqn/pong-sim/device-per/
dqn-cnn) against the JAX package:

- the fused PER step: K sub-steps of sample -> train -> priority write-back
  on the same ring contents, weights and uniforms, against JAX
  ``DevicePerReplay.build_fused_step`` routed through the Pallas kernels in
  interpret mode (the draw through ``hierarchical_sample`` set as the
  ring's ``_draw_fn``, the torso through ``pallas_torso`` with
  ``pallas_interpret``), in fp32: params rtol 1e-4 / atol 1e-5, priorities
  and their running max rtol 1e-4, IS weights rtol 1e-5;
- the ring's writes (with wrap-around) and IS weights, exactly;
- the Pong simulator and the n-step assembler: bit-identical transitions
  for one seed and one action sequence;
- acting: the Ape-X epsilons exactly, greedy and epsilon-greedy actions on
  converted weights (Q values rtol 1e-4);
- the entry point: ``main`` on config 12 with ``--device cpu`` at a small
  size, with the default actors and with ``actor_backend=batched`` on
  both backends, and the refusals (no GPU without ``--device cpu``, rows
  and device envs not ported yet, unknown backends), with ``megabatch``
  under Anakin and on a host-replay row."""

import functools
import tempfile

import numpy as np
import pytest

import jax
import torch

from pytorch_distributed_tpu.config import build_options as jax_options
from pytorch_distributed_tpu.envs.pong_sim import PongSimEnv as JaxPongSim
from pytorch_distributed_tpu.factory import (
    EnvSpec as JaxEnvSpec, build_model as jax_build_model,
    build_train_state_and_step as jax_state_and_step,
    init_params as jax_init_params,
)
from pytorch_distributed_tpu.memory.device_per import (
    DevicePerReplay as JaxDevicePerReplay, per_sample as jax_per_sample,
)
from pytorch_distributed_tpu.models import policies as jax_policies
from pytorch_distributed_tpu.ops.nstep import NStepAssembler as JaxNStep
from pytorch_distributed_tpu.ops.pallas_sampling import hierarchical_sample
from pytorch_distributed_tpu.utils.experience import (
    Transition as JaxTransition,
)
from pytorch_distributed_tpu_torch import main as port_main
from pytorch_distributed_tpu_torch.config import build_options
from pytorch_distributed_tpu_torch.convert import convert_dqn_cnn
from pytorch_distributed_tpu_torch.envs.pong_sim import PongSimEnv
from pytorch_distributed_tpu_torch.factory import (
    EnvSpec, build_model, build_train_state_and_step, module_apply,
)
from pytorch_distributed_tpu_torch.memory.device_per import (
    DevicePerReplay, per_sample,
)
from pytorch_distributed_tpu_torch.models import policies
from pytorch_distributed_tpu_torch.ops.nstep import NStepAssembler
from pytorch_distributed_tpu_torch.utils.experience import (
    REPLAY_FIELDS, Transition,
)

FRAME = (4, 44, 44)
ACTIONS, CAPACITY, ROWS, B, K = 6, 256, 200, 4, 3
TORSO = dict(compute_dtype="float32", pallas_torso=True)


def _chunk(seed: int = 0):
    rng = np.random.default_rng(seed)
    return dict(
        state0=rng.integers(0, 255, (ROWS, *FRAME)).astype(np.uint8),
        action=rng.integers(0, ACTIONS, ROWS).astype(np.int32),
        reward=rng.normal(size=ROWS).astype(np.float32),
        gamma_n=np.full(ROWS, 0.99 ** 5, np.float32),
        state1=rng.integers(0, 255, (ROWS, *FRAME)).astype(np.uint8),
        terminal1=(rng.random(ROWS) < 0.1).astype(np.float32))


def _rings():
    cols = _chunk()
    jring = JaxDevicePerReplay(CAPACITY, FRAME)
    jring.feed_chunk(JaxTransition(**cols))
    # route the JAX ring's draw through the Pallas kernel (interpret mode);
    # build_fused_step reads _draw_fn when it is built
    jring._draw_fn = functools.partial(hierarchical_sample, interpret=True)
    ring = DevicePerReplay(CAPACITY, FRAME, device="cpu")
    ring.feed_chunk(Transition(**cols))
    return jring, ring


def _uniforms(keys):
    return torch.from_numpy(np.stack(
        [np.array(jax.random.uniform(k, (B,))) for k in keys]))


def test_fused_per_step_matches_jax():
    jopt = jax_options(12, pallas_interpret=True, target_model_update=2,
                       **TORSO)
    jspec = JaxEnvSpec(state_shape=FRAME, discrete=True,
                       num_actions=ACTIONS, action_dim=0, norm_val=255.0)
    jmodel = jax_build_model(jopt, jspec)
    jparams = jax_init_params(jopt, jspec, jmodel, seed=0)
    jstate, jstep = jax_state_and_step(jopt, jspec, jmodel, jparams)
    jring, ring = _rings()
    jfused = jring.build_fused_step(jstep, B, donate=False,
                                    steps_per_call=K)

    opt = build_options(12, device="cpu", target_model_update=2, **TORSO)
    model = build_model(opt, EnvSpec(FRAME, ACTIONS, 255.0))
    state, step = build_train_state_and_step(
        opt, model, convert_dqn_cnn(jax.device_get(jparams), FRAME))
    fused = ring.build_fused_step(step, B, steps_per_call=K)

    beta = ring.beta(0)
    for dispatch in range(2):
        keys = jax.random.split(jax.random.PRNGKey(dispatch), K)
        jstate, jring.state, jm = jfused(jstate, jring.state, keys,
                                         np.float32(beta))
        state, m = fused(state, ring.state, _uniforms(keys), beta)
        np.testing.assert_allclose(float(m["learner/critic_loss"]),
                                   float(jm["learner/critic_loss"]),
                                   rtol=1e-4)
    ref = convert_dqn_cnn(jax.device_get(jstate.params), FRAME)
    for k, v in ref.items():
        np.testing.assert_allclose(state.params[k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(ring.state.priority.numpy(),
                               np.asarray(jring.state.priority), rtol=1e-4)
    np.testing.assert_allclose(float(ring.state.max_priority),
                               float(jring.state.max_priority), rtol=1e-4)
    assert int(state.step) == int(jstate.step) == 2 * K
    # the draws moved priorities off their entry value (the max, 1.0)
    assert (ring.state.priority[:ROWS] != 1.0).sum() >= B


def test_ring_writes_and_wraps_like_jax():
    jring, ring = _rings()  # 200 of 256 rows
    jring.state = jring.state._replace(
        max_priority=jax.numpy.float32(2.5))
    ring.state.max_priority.fill_(2.5)
    more = {k: v[:100] for k, v in _chunk(seed=1).items()}
    jring.feed_chunk(JaxTransition(**more))  # wraps: 56 + 44 rows
    ring.feed_chunk(Transition(**more))
    for f in REPLAY_FIELDS + ("priority",):
        np.testing.assert_array_equal(getattr(ring.state, f).numpy(),
                                      np.asarray(getattr(jring.state, f)),
                                      err_msg=f)
    assert ring.state.pos == int(jring.state.pos) == 44
    assert ring.state.fill == int(jring.state.fill) == CAPACITY
    assert float(ring.state.fill_rows) == CAPACITY


def test_is_weights_match_jax():
    jring, ring = _rings()
    rng = np.random.default_rng(1)
    pr = np.zeros(CAPACITY, np.float32)
    pr[:ROWS] = rng.uniform(0.05, 2.0, ROWS)
    jring.state = jring.state._replace(priority=jax.numpy.asarray(pr))
    ring.state.priority.copy_(torch.from_numpy(pr))
    key = jax.random.PRNGKey(5)
    jb = jax_per_sample(jring.state, key, 64, np.float32(0.4),
                        sample_fn=functools.partial(hierarchical_sample,
                                                    interpret=True))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (64,))))
    tb = per_sample(ring.state, u, 0.4)
    np.testing.assert_array_equal(tb.index.numpy(), np.asarray(jb.index))
    np.testing.assert_allclose(tb.weight.numpy(), np.asarray(jb.weight),
                               rtol=1e-5)
    for f in REPLAY_FIELDS:
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)))


def test_pong_and_nstep_are_bit_identical():
    jparams = jax_options(12, early_stop=150).env_params
    params = build_options(12, early_stop=150).env_params
    actions = np.random.default_rng(3).integers(0, ACTIONS, 400)
    streams = []
    for env_cls, nstep_cls, p in ((JaxPongSim, JaxNStep, jparams),
                                  (PongSimEnv, NStepAssembler, params)):
        env, asm, out = env_cls(p, process_ind=2), nstep_cls(5, 0.99), []
        obs = env.reset()
        for a in actions:
            nxt, r, term, info = env.step(a)
            out += asm.feed(obs, a, r, nxt, term,
                            truncated=bool(info.get("truncated", False)))
            obs = env.reset() if term else nxt
        streams.append(out)
    jax_rows, rows = streams
    assert len(rows) == len(jax_rows) > 300
    assert any(float(t.gamma_n) > 0.99 ** 5 + 1e-6 for t in rows)  # tails
    for t, jt in zip(rows, jax_rows):
        for f in REPLAY_FIELDS:
            a, b = np.asarray(getattr(t, f)), np.asarray(getattr(jt, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_acting_matches_jax():
    for i, n, envs in ((0, 8, 16), (3, 8, 16), (0, 1, 1), (5, 6, 2)):
        np.testing.assert_array_equal(
            policies.apex_epsilons(i, n, envs),
            jax_policies.apex_epsilons(i, n, envs))
    jopt = jax_options(12, compute_dtype="float32")
    jspec = JaxEnvSpec(state_shape=FRAME, discrete=True,
                       num_actions=ACTIONS, action_dim=0, norm_val=255.0)
    jmodel = jax_build_model(jopt, jspec)
    jparams = jax_init_params(jopt, jspec, jmodel, seed=3)
    opt = build_options(12, device="cpu", compute_dtype="float32")
    apply_fn = module_apply(build_model(opt, EnvSpec(FRAME, ACTIONS, 255.0)))
    params = convert_dqn_cnn(jax.device_get(jparams), FRAME)
    rng = np.random.default_rng(4)
    obs = rng.integers(0, 255, (16, *FRAME)).astype(np.uint8)
    j_act, j_qmax = jax_policies.build_greedy_act(jmodel.apply)(jparams, obs)
    act, qmax = policies.greedy_act(apply_fn, params, torch.from_numpy(obs))
    np.testing.assert_array_equal(act.numpy(), np.asarray(j_act))
    np.testing.assert_allclose(qmax.numpy(), np.asarray(j_qmax), rtol=1e-4,
                               atol=1e-5)
    # explore rows take the given random action, the others the greedy one
    eps = torch.full((16,), 0.5)
    u = torch.from_numpy(rng.random(16).astype(np.float32))
    ra = torch.from_numpy(rng.integers(0, ACTIONS, 16))
    action, q_sel, q_max = policies.epsilon_greedy_act(
        apply_fn, params, torch.from_numpy(obs), eps, u, ra)
    expect = np.where(u.numpy() < 0.5, ra.numpy(), np.asarray(j_act))
    np.testing.assert_array_equal(action.numpy(), expect)
    q = np.asarray(jmodel.apply(jparams, obs))
    np.testing.assert_allclose(q_sel.numpy(), q[np.arange(16), expect],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(q_max.numpy(), np.asarray(j_qmax), rtol=1e-4,
                               atol=1e-5)


def _small_run(*extra):
    # logs and checkpoints of the run go to a fresh temporary directory
    return ["--config", "12", "--backend", "thread", "--device", "cpu",
            "--memory-size", "2048", "--batch-size", "8", "--steps", "20",
            "--num-actors", "1", "--num-envs-per-actor", "2",
            "--set", "learn_start=64", "--set", "learner_freq=10",
            "--set", f"root_dir={tempfile.mkdtemp(prefix='port_run_')}",
            *extra]


@pytest.mark.parametrize("torso", ["module", "kernel"])
def test_main_trains_config_12_on_cpu(torso):
    summary = port_main.main(_small_run(
        "--set", f"pallas_torso={'true' if torso == 'kernel' else 'false'}",
        "--set", "steps_per_dispatch=2"))
    assert summary["learner/steps"] == 20
    assert summary["replay/size"] > 64
    assert np.isfinite(summary["learner/critic_loss"])
    assert summary["learner/skipped"] == 0.0


@pytest.mark.timeout(240)
@pytest.mark.parametrize("backend", ["thread", "process"])
def test_main_trains_config_12_with_batched_actors(backend):
    """``actor_backend=batched`` through ``main``: the actors infer through
    the shared inference server, which serves every frame they step and
    one tick more per actor (the pipelined schedule's last dispatch)."""
    argv = _small_run("--set", "actor_backend=batched")
    argv[argv.index("--backend") + 1] = backend
    summary = port_main.main(argv)
    assert summary["learner/steps"] == 20
    assert np.isfinite(summary["learner/critic_loss"])
    assert summary["runtime/children_with_cuda"] == 0
    rows, frames = summary["inference/rows"], summary["runtime/actor_steps"]
    assert frames > 64 and 0 <= rows - frames <= 2  # 1 actor x 2 envs
    assert summary["inference/requests"] == rows // 2
    assert summary["inference/param_refreshes"] >= 1


def test_main_without_a_gpu_refuses_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    argv = [a for a in _small_run() if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no GPU"):
        port_main.main(argv)


@pytest.mark.parametrize("what", ["config", "backend",
                                  "actor_backend=device",
                                  "actor_backend=anakin", "option"])
def test_refuses_what_is_not_ported(what, capsys):
    if what == "config":
        with pytest.raises(NotImplementedError):
            build_options(2)  # ddpg: not ported yet (ROADMAP.md Queue A)
    elif what == "backend":
        # both of the reference's backends run; any other is refused
        # before a worker starts
        from pytorch_distributed_tpu_torch import runtime

        with pytest.raises(ValueError, match="unknown backend"):
            runtime.train(build_options(12, device="cpu"), backend="fleet")
    elif what == "actor_backend=device":
        # the device env backend refuses what it still lacks before a
        # worker starts: a device env of another game
        with pytest.raises(ValueError, match="does not implement"):
            port_main.main(_small_run("--set", what, "--set",
                                      "device_env_family=cartpole"))
    elif what == "actor_backend=anakin":
        # megabatching runs under anakin now: K rounds up to M
        summary = port_main.main(_small_run("--set", what,
                                            "--set", "megabatch=2"))
        assert summary["learner/steps"] == 20
        assert np.isfinite(summary["learner/critic_loss"])
        assert "rounded up to 2 (multiple of megabatch 2)" in \
            capsys.readouterr().out
    else:
        # megabatch is an option now; a host-replay row runs unbatched and
        # says so with the reference's line
        argv = _small_run("--set", "megabatch=4")
        argv[argv.index("--config") + 1] = "4"
        summary = port_main.main(argv)
        assert summary["learner/steps"] == 20
        assert ("[learner] megabatch=4 requires a device replay "
                "(memory_type device/device-per; got shared); host-path "
                "learner runs unbatched") in capsys.readouterr().out
