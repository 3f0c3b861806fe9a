"""The DDPG learner and its runs on the CPU:

- the fused dispatch on a ``device-per`` ring (the draw through B1's
  plain version), sequential (K = 4) and in megabatch groups (K = 4, M =
  4), against the JAX package's fused step on the same ring and the same
  uniforms (its draw through the Pallas kernel in interpret mode):
  params, targets, priorities and their running max within rtol 1e-4 and
  atol 5e-5; and against the same updates run by hand from
  ``per_sample``, the step and ``per_update_priorities``, to the bit;
- ``factory.update_flops`` counts the GEMM FLOPs of one decoupled update
  exactly, and DDPG's MFU divides by the fp32 peak;
- a checkpoint epoch of the decoupled state (two nets, two Adam states)
  and of the coupled one round-trips to the bit;
- ``main`` runs rows 2 and 16 on the host rings (``shared``,
  ``prioritized``), the uniform and PER device rings (PER with megabatch
  4 and batched actors), then ``--mode 2`` on the params file; a rerun
  under the same refs resumes from the epoch;
- ``LEARNER_FAULTS=poison_grad@N`` on row 2's host path skips exactly one
  update and leaves the params as they were."""

import functools
import os
import tempfile

import numpy as np
import pytest

import jax
import torch

from pytorch_distributed_tpu.config import build_options as jax_options
from pytorch_distributed_tpu.factory import (
    EnvSpec as JaxEnvSpec, build_megabatch_train_step as jax_mega_step,
    build_model as jax_build_model,
    build_train_state_and_step as jax_state_and_step,
    init_params as jax_init_params,
)
from pytorch_distributed_tpu.memory.device_per import (
    DevicePerReplay as JaxDevicePerReplay,
)
from pytorch_distributed_tpu.ops.pallas_sampling import hierarchical_sample
from pytorch_distributed_tpu.utils.experience import (
    Transition as JaxTransition,
)
from pytorch_distributed_tpu_torch import main as port_main
from pytorch_distributed_tpu_torch.agents import learner as port_learner
from pytorch_distributed_tpu_torch.config import build_options
from pytorch_distributed_tpu_torch.convert import convert_ddpg_mlp
from pytorch_distributed_tpu_torch.factory import (
    EnvSpec, build_megabatch_train_step, build_model,
    build_train_state_and_step, compute_dtype, init_params, update_flops,
)
from pytorch_distributed_tpu_torch.memory.device_per import (
    DevicePerReplay, per_sample, per_update_priorities,
)
from pytorch_distributed_tpu_torch.ops.losses import SKIPPED_KEY
from pytorch_distributed_tpu_torch.utils import checkpoint as ckpt
from pytorch_distributed_tpu_torch.utils.experience import Batch, Transition

OBS, ACT, B, ROWS, CAPACITY = 10, 2, 16, 96, 128
TOL = dict(rtol=1e-4, atol=5e-5)


def _chunk(seed: int = 0):
    rng = np.random.default_rng(seed)
    return dict(
        state0=rng.normal(size=(ROWS, OBS)).astype(np.float32),
        action=rng.uniform(-1, 1, (ROWS, ACT)).astype(np.float32),
        reward=rng.normal(size=ROWS).astype(np.float32),
        gamma_n=np.full(ROWS, 0.99 ** 5, np.float32),
        state1=rng.normal(size=(ROWS, OBS)).astype(np.float32),
        terminal1=(rng.random(ROWS) < 0.1).astype(np.float32))


def _rings(cols):
    kw = dict(action_shape=(ACT,))
    jring = JaxDevicePerReplay(CAPACITY, (OBS,), state_dtype=np.float32,
                               action_dtype=np.float32, **kw)
    jring.feed_chunk(JaxTransition(**cols))
    jring._draw_fn = functools.partial(hierarchical_sample, interpret=True)
    ring = DevicePerReplay(CAPACITY, (OBS,), state_dtype=torch.float32,
                           action_dtype=torch.float32, device="cpu", **kw)
    ring.feed_chunk(Transition(**cols))
    return jring, ring


@functools.lru_cache(maxsize=None)
def _setup():
    over = dict(lr=1e-3, critic_lr=1e-3)
    jopt = jax_options(16, **over)
    jspec = JaxEnvSpec(state_shape=(OBS,), discrete=False, num_actions=0,
                       action_dim=ACT, norm_val=1.0)
    jmodel = jax_build_model(jopt, jspec)
    jparams = jax_init_params(jopt, jspec, jmodel, seed=4)
    jstate, jstep = jax_state_and_step(jopt, jspec, jmodel, jparams)
    opt = build_options(16, device="cpu", **over)
    model = build_model(opt, EnvSpec((OBS,), 0, 1.0, False, ACT))
    state, step = build_train_state_and_step(
        opt, model, convert_ddpg_mlp(jax.device_get(jparams)))
    return (jopt, jmodel, jstate, jstep), (opt, model, state, step)


def _conv(tree):
    return convert_ddpg_mlp(jax.device_get(tree))


@pytest.mark.parametrize("megabatch", [1, 4], ids=["sequential", "M4"])
def test_fused_dispatch_matches_jax(megabatch):
    (jopt, jmodel, jstate, jstep), (opt, model, state, step) = _setup()
    jmega = mega = None
    if megabatch > 1:
        jmega = jax_mega_step(jopt, jmodel)
        mega = build_megabatch_train_step(opt, model)
    jring, ring = _rings(_chunk())
    K = 4
    jfused = jring.build_fused_step(jstep, B, donate=False, steps_per_call=K,
                                    megabatch=megabatch,
                                    megabatch_step=jmega)
    fused = ring.build_fused_step(step, B, steps_per_call=K,
                                  megabatch=megabatch, megabatch_step=mega)
    beta = ring.beta(0)
    for dispatch in range(2):
        keys = jax.random.split(jax.random.PRNGKey(dispatch), K)
        jstate, jring.state, jm = jfused(jstate, jring.state, keys,
                                         np.float32(beta))
        us = torch.from_numpy(np.stack(
            [np.array(jax.random.uniform(k, (B,))) for k in keys]))
        state, m = fused(state, ring.state, us, beta)
        for k in ("learner/critic_loss", "learner/actor_loss"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=k)
    for net in ("actor", "critic"):
        for tree, jtree in ((state.params, jstate.params),
                            (state.target_params, jstate.target_params)):
            ref = _conv(jtree[net])
            for k, v in ref.items():
                np.testing.assert_allclose(tree[net][k].numpy(), v.numpy(),
                                           err_msg=k, **TOL)
    np.testing.assert_allclose(ring.state.priority.numpy(),
                               np.asarray(jring.state.priority), **TOL)
    np.testing.assert_allclose(float(ring.state.max_priority),
                               float(jring.state.max_priority), rtol=1e-4)
    assert int(state.step) == int(jstate.step) == 2 * K
    assert (ring.state.priority[:ROWS] != 1.0).sum() >= B


def test_fused_dispatch_is_the_updates_run_by_hand():
    _jax, (opt, _model, state, step) = _setup()
    cols = _chunk(seed=1)
    _jring, ring = _rings(cols)
    _jring2, hand = _rings(cols)
    K = 3
    fused = ring.build_fused_step(step, B, steps_per_call=K)
    us = torch.rand((K, B), generator=torch.Generator().manual_seed(0))
    beta = 0.5
    got, m = fused(state, ring.state, us, beta)
    want = state
    for k in range(K):
        batch = per_sample(hand.state, us[k], beta)
        want, wm, td = step(want, batch)
        per_update_priorities(hand.state, batch.index, td, hand.alpha,
                              wm[SKIPPED_KEY])
    for net in ("actor", "critic"):
        for k, v in want.params[net].items():
            assert torch.equal(got.params[net][k], v), k
    assert torch.equal(ring.state.priority, hand.state.priority)
    assert float(m["learner/critic_loss"]) == float(wm["learner/critic_loss"])


def test_update_flops_count_the_gemms_and_mfu_is_fp32():
    """One decoupled update at batch 64 on the reacher (S = 10, d = 2):
    per row, the actor's forward is A = 10*300 + 300*200 + 200*2 and the
    critic's C = 10*400 + 402*300 + 300*1 multiply-adds; the critic stage
    runs the targets' A + C, the critic's C, its weight gradients C and
    the input gradients of its two upper layers 300 + 402*300; the actor
    stage runs A + C forward, the same two input gradients of the critic,
    the actor's weight gradients A and the input gradients of its upper
    layers 200*2 + 300*200."""
    opt = build_options(16, device="cpu")
    A = 10 * 300 + 300 * 200 + 200 * 2
    C = 10 * 400 + 402 * 300 + 300
    up = 300 + 402 * 300
    macs = (A + 2 * C + C + up) + (A + C + up + A + 200 * 2 + 300 * 200)
    spec = EnvSpec((OBS,), 0, 1.0, False, ACT)
    assert update_flops(opt, spec) == 2 * 64 * macs
    assert compute_dtype(opt) == torch.float32
    assert opt.model_params.compute_dtype == "bfloat16"  # not read by DDPG


@pytest.mark.parametrize("coupled", [False, True],
                         ids=["decoupled", "coupled"])
def test_epoch_round_trips_the_state(tmp_path, coupled):
    opt = build_options(2, device="cpu", ddpg_coupled_update=coupled)
    spec = EnvSpec((3,), 0, 1.0, False, 1)
    state, step = build_train_state_and_step(
        opt, build_model(opt, spec), init_params(opt, spec, seed=0))
    rng = np.random.default_rng(0)
    batch = Batch(state0=torch.from_numpy(rng.normal(size=(8, 3)).astype(
        np.float32)), action=torch.rand(8, 1) * 2 - 1,
        reward=torch.ones(8), gamma_n=torch.full((8,), 0.9),
        state1=torch.zeros(8, 3), terminal1=torch.zeros(8),
        weight=torch.ones(8), index=torch.arange(8))
    state, _m, _td = step(state, batch)
    name = str(tmp_path / "models" / "r")
    ckpt.save_epoch(name, state=state, extras={"learner_step": 1})
    info = ckpt.resolve_epoch(name)
    back = ckpt.load_epoch_state(info)
    flat = lambda s: sorted(_leaves(s))
    assert [k for k, _v in flat(back)] == [k for k, _v in flat(state)]
    for (k, a), (_k, b) in zip(flat(back), flat(state)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    report = ckpt.fsck(ckpt.ckpt_root(name))
    assert not report["violations"] and report["newest_complete"] == 0


def _leaves(x, prefix=""):
    if isinstance(x, torch.Tensor):
        return [(prefix, x)]
    items = x._asdict().items() if hasattr(x, "_asdict") else x.items()
    return [leaf for k, v in items for leaf in _leaves(v, f"{prefix}/{k}")]


def _run(config: int, *extra: str, backend: str = "thread",
         steps: int = 100, root: str = ""):
    root = root or tempfile.mkdtemp(prefix=f"port_ddpg{config}_")
    argv = ["--config", str(config), "--backend", backend, "--device", "cpu",
            "--memory-size", "1024", "--batch-size", "16",
            "--steps", str(steps), "--num-actors", "1",
            "--num-envs-per-actor", "2", "--set", "learn_start=64",
            "--set", "learner_freq=50", "--set", "early_stop=60",
            "--set", "evaluator_nepisodes=0", "--set", f"root_dir={root}",
            "--set", "refs=r", *extra]
    return port_main.main(argv), root


@pytest.mark.timeout(240)
@pytest.mark.parametrize("config,backend,extra", [
    (2, "thread", ()), (16, "thread", ()),
    (2, "process", ("--set", "memory_type=prioritized")),
    (16, "process", ("--set", "memory_type=device")),
    (16, "process", ("--set", "memory_type=device-per", "--set",
                     "megabatch=4", "--set", "actor_backend=batched"))],
    ids=["2-shared", "16-shared", "2-prioritized", "16-device",
         "16-per-M4-batched"])
def test_rows_run_end_to_end(config, backend, extra):
    # the evaluator writes the params file mode 2 reads
    summary, root = _run(config, *extra, "--set", "evaluator_nepisodes=1",
                         backend=backend)
    assert summary["learner/steps"] == 100
    for k in ("learner/critic_loss", "learner/actor_loss"):
        assert np.isfinite(summary[k]), k
    assert summary["learner/skipped"] == 0.0
    assert summary["replay/size"] > 64
    if backend == "process":
        assert summary["runtime/children_with_cuda"] == 0
    if "actor_backend=batched" in extra:
        assert summary["inference/packed"] == 0
        assert summary["inference/rows"] >= summary["runtime/actor_steps"]
    stats = port_main.main(["--config", str(config), "--mode", "2",
                            "--device", "cpu", "--model-file",
                            os.path.join(root, "models", "r"),
                            "--set", "tester_nepisodes=1"])
    assert stats["nepisodes"] == 1.0 and np.isfinite(stats["avg_reward"])
    assert stats["avg_steps"] == (200.0 if config == 2 else 150.0)


def test_row_2_resumes_from_its_epoch():
    summary, root = _run(2, "--set", "memory_type=device-per", steps=40)
    assert summary["learner/steps"] == 40
    again, _root = _run(2, "--set", "memory_type=device-per", "--resume",
                        "r", steps=80, root=root)
    assert again["learner/resumed_from_step"] == 40
    assert again["learner/steps"] == 80


def test_row_2_poison_grad_skips_one_update(monkeypatch):
    seen = []
    real = port_learner.build_train_state_and_step

    def spy(opt, model, params):
        state, step = real(opt, model, params)

        def step_spy(st, batch):
            out = step(st, batch)
            same = all(torch.equal(st.params[n][k], out[0].params[n][k])
                       for n in ("actor", "critic") for k in st.params[n])
            seen.append((float(out[1][SKIPPED_KEY]),
                         bool(torch.isnan(batch.reward).any()), same))
            return out
        return state, step_spy

    monkeypatch.setattr(port_learner, "build_train_state_and_step", spy)
    monkeypatch.setenv("LEARNER_FAULTS", "poison_grad@30")
    summary, _root = _run(2, steps=60)
    assert summary["learner/steps"] == 60
    assert summary[SKIPPED_KEY] == 1.0
    assert summary["health/rollbacks"] == 0
    assert [s for s in seen if s[0] == 1.0] == [(1.0, True, True)]
    assert sum(nan for _s, nan, _eq in seen) == 1
    assert not any(eq for s, _nan, eq in seen if s == 0.0)
