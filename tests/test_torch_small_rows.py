"""CONFIGS rows 1, 3, 4, 6 and 8 in the port, against the JAX package
where the reference has a twin, on the CPU:

- ``FakeChainEnv`` and ``CartPoleEnv``: the same action sequence gives
  bit-identical observation, reward, terminal and info streams (resets
  and ``early_stop`` truncations included);
- ``dqn-mlp``: the forward on flax params carried over by
  ``convert.convert_dqn_mlp`` within fp32 rounding (rtol 1e-5, atol
  1e-6), and the published flat vector in the reference's
  ``ravel_pytree`` layout, exactly;
- row 1 learns the chain through ``main`` (process backend, 1,000
  updates at replay ratio 4): the evaluator reaches ``avg_reward`` 1.0,
  and mode 2 on its best params solves every episode in the optimal 7
  steps;
- rows 3, 4, 6 and 8 (row 4 also on the native ring, row 8 also under
  Anakin, and row 1 with batched actors, whose server takes float32
  states) run 200 updates end to end through ``main`` with finite
  losses;
- row 6's ``poison_grad`` drill: the NaN batch is skipped once, the
  params unchanged across that update, and no rollback;
- row 6 resumes with its ring: ``checkpoint_replay`` writes the host PER
  ring's rows and leaves into the epoch, and ``--resume`` restores them
  with the learner's host generator."""

import json
import os
import tempfile

import numpy as np
import pytest

import jax
import torch
from jax.flatten_util import ravel_pytree

from pytorch_distributed_tpu.config import build_options as jax_options
from pytorch_distributed_tpu.envs.classic import CartPoleEnv as JaxCartPole
from pytorch_distributed_tpu.envs.fake_env import FakeChainEnv as JaxChain
from pytorch_distributed_tpu.models.dqn_mlp import DqnMlpModel as JaxMlp
from pytorch_distributed_tpu_torch import main as port_main
from pytorch_distributed_tpu_torch.agents import learner as port_learner
from pytorch_distributed_tpu_torch.agents.param_store import flatten_into
from pytorch_distributed_tpu_torch.config import build_options
from pytorch_distributed_tpu_torch.convert import convert_dqn_mlp
from pytorch_distributed_tpu_torch.envs.classic import CartPoleEnv
from pytorch_distributed_tpu_torch.envs.fake_env import FakeChainEnv
from pytorch_distributed_tpu_torch.factory import (
    EnvSpec, build_model, module_apply,
)
from pytorch_distributed_tpu_torch.ops.losses import SKIPPED_KEY


@pytest.mark.parametrize("config,env_cls,jax_cls", [
    (1, FakeChainEnv, JaxChain), (3, CartPoleEnv, JaxCartPole)])
def test_env_streams_are_bit_identical(config, env_cls, jax_cls):
    params = build_options(config, early_stop=60).env_params
    jparams = jax_options(config, early_stop=60).env_params
    actions = np.random.default_rng(config).integers(0, 2, 400)
    streams = []
    for cls, p in ((env_cls, params), (jax_cls, jparams)):
        env, out = cls(p, process_ind=3), []
        obs = env.reset()
        for a in actions:
            nxt, r, term, info = env.step(a)
            out.append((obs, r, term, dict(info)))
            obs = env.reset() if term else nxt
        streams.append(out)
    assert sum(t for _o, _r, t, _i in streams[0]) >= 3  # several episodes
    for (o, r, t, i), (jo, jr, jt, ji) in zip(*streams):
        assert o.dtype == jo.dtype and np.array_equal(o, jo)
        assert (r, t, i) == (jr, jt, ji)
    if config == 1:
        np.testing.assert_array_equal(FakeChainEnv(params).optimal_q(0.99),
                                      JaxChain(jparams).optimal_q(0.99))


def test_dqn_mlp_forward_and_layout_match_flax():
    jmodel = JaxMlp(action_space=2, hidden_dim=32)
    jparams = jmodel.init(jax.random.PRNGKey(0), np.zeros((1, 8), np.float32))
    opt = build_options(1, device="cpu", hidden_dim=32)
    model = build_model(opt, EnvSpec((8,), 2, 1.0))
    sd = convert_dqn_mlp(jax.device_get(jparams))
    obs = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    q = module_apply(model)(sd, torch.from_numpy(obs))
    np.testing.assert_allclose(q.detach().numpy(),
                               np.asarray(jmodel.apply(jparams, obs)),
                               rtol=1e-5, atol=1e-6)
    flat = flatten_into(sd, torch.empty(sum(v.numel() for v in sd.values())),
                        (8,))
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(ravel_pytree(jparams)[0]))
    # the port's own init has the reference's structure and gains
    assert set(model.state_dict()) == set(sd)
    assert not any(v.any() for k, v in model.state_dict().items()
                   if k.endswith(".bias"))


def _run(config: int, *extra: str, backend: str = "thread",
         steps: int = 200, batch: int = 8):
    root = tempfile.mkdtemp(prefix=f"port_row{config}_")
    argv = ["--config", str(config), "--backend", backend, "--device", "cpu",
            "--memory-size", "1024", "--batch-size", str(batch),
            "--steps", str(steps), "--num-actors", "1",
            "--num-envs-per-actor", "2", "--set", "learn_start=64",
            "--set", "learner_freq=50", "--set", "early_stop=100",
            "--set", "evaluator_nepisodes=0", "--set", f"root_dir={root}",
            "--set", "refs=r", *extra]
    return port_main.main(argv), root


def test_row_1_learns_the_chain():
    # paced at 4 samples a frame, so the data an update sees does not
    # depend on how fast this host runs the learner against the actors
    summary, root = _run(1, "--set", "evaluator_nepisodes=2",
                         "--set", "evaluator_freq=1", "--set",
                         "early_stop=50", "--set", "max_replay_ratio=4",
                         "--num-actors", "2", backend="process",
                         steps=1000, batch=32)
    assert summary["learner/steps"] == 1000
    with open(os.path.join(root, "logs", "r", "scalars.jsonl")) as f:
        rewards = [row["value"] for row in map(json.loads, f)
                   if row["tag"] == "evaluator/avg_reward"]
    assert rewards and max(rewards) == 1.0
    stats = port_main.main(["--config", "1", "--mode", "2", "--device",
                            "cpu", "--model-file",
                            os.path.join(root, "models", "r_best"),
                            "--set", "tester_nepisodes=3",
                            "--set", "early_stop=50"])
    assert stats["avg_reward"] == 1.0 and stats["avg_steps"] == 7.0
    assert stats["nepisodes_solved"] == 3.0


@pytest.mark.timeout(240)
@pytest.mark.parametrize("config,backend,extra", [
    (1, "process", ("--set", "actor_backend=batched")), (3, "thread", ()),
    (4, "process", ()), (4, "process", ("--set", "memory_type=native")),
    (6, "process", ()), (8, "process", ()),
    (8, "thread", ("--set", "actor_backend=anakin"))],
    ids=["1-batched", "3", "4-process", "4-native", "6-process",
         "8-process", "8-anakin"])
def test_rows_run_end_to_end(config, backend, extra):
    summary, _root = _run(config, *extra, backend=backend)
    assert summary["learner/steps"] == 200
    assert np.isfinite(summary["learner/critic_loss"])
    assert summary["learner/skipped"] == 0.0
    assert summary["replay/size"] > 64
    if backend == "process":
        assert summary["runtime/children_with_cuda"] == 0


def test_row_6_poison_grad_skips_one_update(monkeypatch):
    """``LEARNER_FAULTS=poison_grad@40``: the learner NaNs the rewards of
    its 40th dispatch's host batch; the guard skips exactly that update,
    whose params come out as they went in."""
    seen = []
    real = port_learner.build_train_state_and_step

    def spy(opt, model, params):
        state, step = real(opt, model, params)

        def step_spy(st, batch):
            out = step(st, batch)
            seen.append((float(out[1][SKIPPED_KEY]),
                         bool(torch.isnan(batch.reward).any()),
                         all(torch.equal(st.params[k], out[0].params[k])
                             for k in st.params)))
            return out
        return state, step_spy

    monkeypatch.setattr(port_learner, "build_train_state_and_step", spy)
    monkeypatch.setenv("LEARNER_FAULTS", "poison_grad@40")
    summary, _root = _run(6, steps=80)
    assert summary["learner/steps"] == 80
    assert summary[SKIPPED_KEY] == 1.0
    assert summary["health/rollbacks"] == 0
    skipped = [s for s in seen if s[0] == 1.0]
    assert skipped == [(1.0, True, True)]
    assert sum(nan for _s, nan, _eq in seen) == 1
    assert not any(eq for s, _nan, eq in seen if s == 0.0)


def test_row_6_resumes_with_its_ring():
    summary, root = _run(6, "--set", "checkpoint_replay=true",
                         backend="process", steps=40)
    assert summary["learner/steps"] == 40
    again, _root = _run(6, "--set", "checkpoint_replay=true",
                        "--set", f"root_dir={root}", "--resume", "r",
                        backend="process", steps=80)
    assert again["learner/resumed_from_step"] == 40
    assert again["learner/steps"] == 80
    assert 64 < again["replay/restored_rows"] <= 1024
