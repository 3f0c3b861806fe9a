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
  under Anakin and on a host-replay row;
- rows 13 (``drqn-mlp`` on the host segment ring) and 14 (``drqn-cnn`` on
  the device segment ring, frame-packed) through ``main`` at a tiny size:
  train, mode 2, and a ``--resume`` with ``checkpoint_replay`` that
  restores the segment ring; ``megabatch`` on row 14 runs the sequential
  step with the reference's line; a segment snapshot refused by a
  transition ring and a carry of another width refused by a segment
  ring; row 13's learning bar at the JAX package's geometry (slow: the
  card runs it in ``chip_smoke.py r2d2``)."""

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
            build_options(5)  # Atari: needs ALE and its ROMs
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


def _r2d2_run(config: int, root: str, backend: str, *extra):
    return ["--config", str(config), "--backend", backend, "--device", "cpu",
            "--num-actors", "1", "--num-envs-per-actor", "2",
            "--memory-size", "256", "--batch-size", "4", "--steps", "12",
            "--set", "seq_len=6", "--set", "seq_overlap=3",
            "--set", "burn_in=2", "--set", "nstep=3",
            "--set", "learn_start=4", "--set", "learner_freq=6",
            "--set", "evaluator_nepisodes=1", "--set", "early_stop=60",
            "--set", "hidden_dim=16", "--set", "lstm_dim=8",
            "--set", f"root_dir={root}", "--set", "refs=r",
            "--no-tensorboard", *extra]


@pytest.mark.timeout(240)
@pytest.mark.parametrize("config,backend", [(13, "process"), (14, "thread")])
def test_main_trains_and_tests_r2d2_rows_on_cpu(config, backend, capsys):
    root = tempfile.mkdtemp(prefix="port_r2d2_")
    summary = port_main.main(_r2d2_run(config, root, backend, "--set",
                                       "checkpoint_replay=true"))
    assert summary["learner/steps"] == 12
    assert np.isfinite(summary["learner/critic_loss"])
    assert summary["learner/skipped"] == 0.0
    assert summary["replay/size"] > 4
    assert summary["ingest/validated"] >= summary["replay/size"]
    stats = port_main.main(["--config", str(config), "--mode", "2",
                            "--device", "cpu", "--model-file",
                            f"{root}/models/r", "--set", "early_stop=60",
                            "--set", "tester_nepisodes=2",
                            "--set", "hidden_dim=16", "--set",
                            "lstm_dim=8"])
    assert stats["nepisodes"] == 2.0 and np.isfinite(stats["avg_reward"])
    # the same refs resumes: state and segment ring from the final epoch
    argv = _r2d2_run(config, root, backend, "--set",
                     "checkpoint_replay=true", "--resume", "r")
    argv[argv.index("--steps") + 1] = "18"
    again = port_main.main(argv)
    out = capsys.readouterr().out
    assert again["learner/resumed_from_step"] == 12
    assert again["learner/steps"] == 18
    assert again["replay/restored_rows"] == summary["replay/size"]
    assert "replay restored from epoch" in out


def _dtqn_run(config: int, root: str, *extra):
    """A DTQN row at a small size: width 32, segments of 6 steps."""
    argv = _r2d2_run(config, root, "process", *extra)
    i = argv.index("hidden_dim=16")
    argv[i - 1:i + 3] = ["--set", "tf_dim=32", "--set", "moe_experts=4"]
    return argv


@pytest.mark.timeout(240)
@pytest.mark.parametrize("config", [15, 17, 18])
def test_main_trains_and_tests_dtqn_rows_on_cpu(config, capsys):
    root = tempfile.mkdtemp(prefix="port_dtqn_")
    summary = port_main.main(_dtqn_run(config, root, "--set",
                                       "checkpoint_replay=true"))
    assert summary["learner/steps"] == 12
    assert np.isfinite(summary["learner/critic_loss"])
    assert summary["learner/skipped"] == 0.0
    assert summary["replay/size"] > 4
    # the MoE's load-balancing loss, reported and finite (E sum f P >= 1)
    assert ("learner/moe_aux" in summary) == (config == 17)
    if config == 17:
        assert summary["learner/moe_aux"] >= 1.0 - 1e-6
    stats = port_main.main(["--config", str(config), "--mode", "2",
                            "--device", "cpu", "--model-file",
                            f"{root}/models/r", "--set", "early_stop=60",
                            "--set", "tester_nepisodes=2", "--set",
                            "seq_len=6", "--set", "tf_dim=32", "--set",
                            "moe_experts=4"])
    assert stats["nepisodes"] == 2.0 and np.isfinite(stats["avg_reward"])
    # the same refs resumes: state and the width-1 segment ring
    argv = _dtqn_run(config, root, "--set", "checkpoint_replay=true",
                     "--resume", "r")
    argv[argv.index("--steps") + 1] = "18"
    again = port_main.main(argv)
    out = capsys.readouterr().out
    assert again["learner/resumed_from_step"] == 12
    assert again["learner/steps"] == 18
    assert again["replay/restored_rows"] == summary["replay/size"]
    assert "replay restored from epoch" in out


@pytest.mark.parametrize("field", ["sp_size", "ep_size", "pp_size",
                                   "mp_size", "parallel_params.sp_size"])
def test_mesh_fields_raise_on_the_port(field):
    """The reference's mesh knobs come with Queue A item 9; a --set of one
    raises instead of being dropped."""
    with pytest.raises(ValueError, match="unknown option"):
        build_options(15, device="cpu", **{field: 2})


def test_r2d2_megabatch_runs_the_sequential_step(capsys):
    root = tempfile.mkdtemp(prefix="port_r2d2_")
    summary = port_main.main(_r2d2_run(14, root, "thread",
                                       "--set", "megabatch=2"))
    assert summary["learner/steps"] == 12
    assert ("[learner] megabatch=2 is not supported for agent_type=r2d2"
            in capsys.readouterr().out)


def test_segment_snapshots_refuse_the_wrong_ring():
    from pytorch_distributed_tpu_torch.factory import build_memory, probe_env
    from pytorch_distributed_tpu_torch.memory.sequence_replay import Segment
    from pytorch_distributed_tpu_torch.utils.checkpoint import (
        CheckpointMismatch, validate_snapshot,
    )

    opt = build_options(13, device="cpu", seq_len=4, seq_overlap=2,
                        lstm_dim=8, memory_size=64)
    spec = probe_env(opt)
    host = build_memory(opt, spec).learner_side
    host.memory.feed(Segment(
        obs=np.zeros((5, *spec.state_shape), np.float32),
        action=np.zeros(4, np.int32), reward=np.zeros(4, np.float32),
        terminal=np.zeros(4, np.float32), mask=np.ones(4, np.float32),
        c0=np.zeros(8, np.float32), h0=np.zeros(8, np.float32)))
    snap = host.snapshot()
    validate_snapshot(host, snap)
    flat = build_memory(build_options(1, device="cpu"), spec).learner_side
    with pytest.raises(CheckpointMismatch, match="segment rows"):
        validate_snapshot(flat, snap)
    with pytest.raises(CheckpointMismatch, match="transition rows"):
        validate_snapshot(host, {"state0": np.zeros((1, 8)),
                                 "reward": np.zeros(1)})
    wide = build_memory(build_options(13, device="cpu", seq_len=4,
                                      seq_overlap=2, lstm_dim=16,
                                      memory_size=64), spec).learner_side
    with pytest.raises(CheckpointMismatch, match="carry width 8"):
        validate_snapshot(wide, snap)
    for m in (host, flat, wide):
        m.close()


def test_dtqn_segment_snapshots_are_width_one():
    """A DTQN ring stores the 1-dim placeholder carry; its snapshots
    restore into a DTQN ring, host or device, and an LSTM ring of either
    kind refuses them."""
    from pytorch_distributed_tpu_torch.factory import (
        build_memory, lstm_dim_of, probe_env,
    )
    from pytorch_distributed_tpu_torch.memory.sequence_replay import Segment
    from pytorch_distributed_tpu_torch.utils.checkpoint import (
        CheckpointMismatch, validate_snapshot,
    )

    kw = dict(device="cpu", seq_len=4, seq_overlap=2, memory_size=64)
    opt = build_options(15, **kw)
    assert lstm_dim_of(opt) == 1
    spec = probe_env(opt)
    host = build_memory(opt, spec).learner_side
    host.memory.feed(Segment(
        obs=np.zeros((5, *spec.state_shape), np.float32),
        action=np.zeros(4, np.int32), reward=np.zeros(4, np.float32),
        terminal=np.zeros(4, np.float32), mask=np.ones(4, np.float32),
        c0=np.zeros(1, np.float32), h0=np.zeros(1, np.float32)))
    snap = host.snapshot()
    assert np.asarray(snap["c0"]).shape == (1, 1)
    rings = [host]
    for config, extra in ((15, {}), (13, {"lstm_dim": 8})):
        for mt in ("sequence", "device-sequence"):
            ring = build_memory(build_options(config, memory_type=mt, **kw,
                                              **extra), spec).learner_side
            if mt == "device-sequence":
                ring.attach(torch.device("cpu"))
            rings.append(ring)
            if config == 15:
                validate_snapshot(ring, snap)
            else:
                with pytest.raises(CheckpointMismatch,
                                   match="carry width 1"):
                    validate_snapshot(ring, snap)
    for m in rings:
        m.close()


@pytest.mark.slow
@pytest.mark.timeout(2400)
def test_dtqn_chain_learns_through_main():
    """Row 15's bar at the JAX package's own geometry
    (tests/test_ring_attention.py:132-174: width 128, segments of 16,
    1,500 updates, a second seed allowed), on the process backend: mode 2
    on the trained params solves 5 of 5 episodes.  The health plane's
    rollback is off, as in chip_smoke.py's run of this bar: the loss
    level rises when the ring wraps, after the detector's warm-up, which
    reads as a divergence streak (ROADMAP.md Queue C)."""
    last = None
    for seed in (100, 101):
        root = tempfile.mkdtemp(prefix="port_dtqn_bar_")
        port_main.main([
            "--config", "15", "--backend", "process", "--device", "cpu",
            "--seed", str(seed), "--num-actors", "2", "--steps", "1500",
            "--memory-size", "8192", "--batch-size", "16",
            "--set", "learn_start=32", "--set", "seq_len=16",
            "--set", "seq_overlap=8", "--set", "nstep=3",
            "--set", "actor_sync_freq=20", "--set", "param_publish_freq=5",
            "--set", "learner_freq=50", "--set", "evaluator_freq=2",
            "--set", "max_replay_ratio=32.0", "--set", "lr=1e-3",
            "--set", "target_model_update=100", "--set", "early_stop=200",
            "--set", "eps=0.7", "--set", "eps_alpha=3.0",
            "--set", "rollback=false",
            "--set", f"root_dir={root}", "--set", "refs=bar",
            "--no-tensorboard"])
        last = port_main.main(["--config", "15", "--mode", "2", "--device",
                               "cpu", "--model-file", f"{root}/models/bar",
                               "--set", "tester_nepisodes=5", "--set",
                               "seq_len=16", "--set", "early_stop=200"])
        if (last["nepisodes_solved"] == 5.0 and last["avg_reward"] >= 0.9
                and last["avg_steps"] <= 10):
            break
    assert last["nepisodes_solved"] == 5.0
    assert last["avg_reward"] >= 0.9
    assert last["avg_steps"] <= 10


@pytest.mark.slow
@pytest.mark.timeout(1200)
def test_r2d2_chain_learns_through_main():
    """Row 13's bar at the JAX package's own geometry
    (tests/test_sequence.py:265-283) on the process backend: mode 2 on
    the trained params reaches the chain's end."""
    root = tempfile.mkdtemp(prefix="port_r2d2_bar_")
    port_main.main([
        "--config", "13", "--backend", "process", "--device", "cpu",
        "--num-actors", "2", "--steps", "1200", "--memory-size", "4096",
        "--batch-size", "16", "--set", "seq_len=16", "--set",
        "seq_overlap=8", "--set", "burn_in=4", "--set", "nstep=3",
        "--set", "learn_start=8", "--set", "actor_sync_freq=20",
        "--set", "param_publish_freq=5", "--set", "learner_freq=50",
        "--set", "evaluator_freq=1", "--set", "max_replay_ratio=64.0",
        "--set", "lr=2e-3", "--set", "target_model_update=100",
        "--set", f"root_dir={root}", "--set", "refs=bar",
        "--no-tensorboard"])
    stats = port_main.main(["--config", "13", "--mode", "2", "--device",
                            "cpu", "--model-file", f"{root}/models/bar",
                            "--set", "tester_nepisodes=5"])
    assert stats["avg_reward"] >= 0.9
    assert stats["avg_steps"] <= 10
