"""The DDPG actor and greedy evaluation (agents/actor.py ``DdpgActor``,
agents/inference.py's DDPG branch, agents/evaluator.py), on the CPU:

- the ``inline``, ``pipelined`` and ``batched`` (one client of the
  inference server) streams are bit-identical in the port, as the JAX
  package holds its own (tests/test_actor_pipeline.py:75), with episode
  ends, and so OU path resets, inside the window;
- against the JAX actor on the same weights (converted with
  ``convert_ddpg_mlp``) and seed: every OU sample bit-equal, and the
  transitions' actions and states within fp32 rounding (rtol 1e-5, atol
  1e-5) over a short horizon;
- the evaluator's greedy return against the reference's on the same
  weights, within rtol 1e-4 (two reacher episodes: fp32 rounding in the
  policy's forward moves the damped arm by far less);
- a ``device`` or ``anakin`` actor backend steps down to ``pipelined``."""

import warnings

import numpy as np
import pytest

import jax

from pytorch_distributed_tpu.agents import actor as jax_actor
from pytorch_distributed_tpu.agents.evaluator import (
    greedy_episodes as jax_greedy_episodes,
)
from pytorch_distributed_tpu.config import build_options as jax_options
from pytorch_distributed_tpu.envs.classic import ReacherEnv as JaxReacher
from pytorch_distributed_tpu.factory import (
    build_model as jax_build_model, init_params as jax_init_params,
    probe_env as jax_probe_env,
)
from pytorch_distributed_tpu.utils.random_process import (
    OrnsteinUhlenbeckProcess as JaxOU,
)
from pytorch_distributed_tpu_torch.agents import actor as port_actor
from pytorch_distributed_tpu_torch.agents.actor import (
    bounded_actor_run, snapshot_store,
)
from pytorch_distributed_tpu_torch.agents.evaluator import greedy_episodes
from pytorch_distributed_tpu_torch.agents.inference import InferenceServer
from pytorch_distributed_tpu_torch.config import build_options
from pytorch_distributed_tpu_torch.convert import convert_ddpg_mlp
from pytorch_distributed_tpu_torch.envs.classic import ReacherEnv
from pytorch_distributed_tpu_torch.factory import (
    build_model, probe_env, resolve_actor_backend,
)
from pytorch_distributed_tpu_torch.utils.experience import REPLAY_FIELDS
from pytorch_distributed_tpu_torch.utils.random_process import (
    OrnsteinUhlenbeckProcess,
)

TICKS = 70


def _opt(tmp_path, backend, config=16, **kw):
    kw.setdefault("actor_freq", 10 ** 9)
    return build_options(config, device="cpu", num_actors=2,
                         num_envs_per_actor=2, root_dir=str(tmp_path),
                         refs=f"d_{backend}", actor_backend=backend,
                         early_stop=30, **kw)


def _assert_streams_equal(a, b):
    assert len(a) == len(b) > TICKS
    for t1, t2 in zip(a, b):
        for f in REPLAY_FIELDS:
            x, y = np.asarray(getattr(t1, f)), np.asarray(getattr(t2, f))
            assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.timeout(240)
def test_inline_pipelined_and_batched_streams_are_identical(tmp_path):
    runs = {b: bounded_actor_run(_opt(tmp_path, b), TICKS, process_ind=1)
            for b in ("inline", "pipelined")}
    opt_b = _opt(tmp_path, "batched")
    spec = probe_env(opt_b)
    server = InferenceServer(opt_b, spec, snapshot_store(opt_b, spec, 0),
                             in_process=True)
    client = server.make_client(1)
    server.start()
    try:
        runs["batched"] = bounded_actor_run(opt_b, TICKS, spec=spec,
                                            process_ind=1, inference=client)
    finally:
        server.stop()
    a = runs["inline"]["stream"]
    assert a[0].action.dtype == np.float32 and a[0].action.shape == (2,)
    assert all(np.abs(t.action).max() <= 1.0 for t in a)
    assert any(float(t.terminal1) == 0.0 and float(t.gamma_n) > 0.99 ** 5
               for t in a), "no truncated tail in the window"
    for b in ("pipelined", "batched"):
        _assert_streams_equal(a, runs[b]["stream"])
    st = server.stats
    assert st["requests"] == TICKS + 1 and st["rows"] == 2 * (TICKS + 1)
    assert st["packed"] == 0  # low-dim rows are never frame-packed


def _recorded_samples(monkeypatch, cls):
    seen = []
    real = cls.sample

    def sample(self):
        x = real(self)
        seen.append(x.copy())
        return x

    monkeypatch.setattr(cls, "sample", sample)
    return seen


@pytest.mark.timeout(240)
def test_stream_matches_the_jax_actor(tmp_path, monkeypatch):
    ticks = 40
    jopt = jax_options(16, num_actors=2, num_envs_per_actor=2,
                       actor_backend="pipelined", early_stop=30,
                       actor_freq=10 ** 9, root_dir=str(tmp_path),
                       refs="jax")
    jspec = jax_probe_env(jopt)
    jparams = jax_init_params(jopt, jspec, jax_build_model(jopt, jspec),
                              seed=0)
    sd = convert_ddpg_mlp(jax.device_get(jparams))
    # the port's snapshot is the JAX package's, converted
    monkeypatch.setattr(port_actor, "init_params",
                        lambda *a, **k: {k2: v.clone()
                                         for k2, v in sd.items()})
    port_noise = _recorded_samples(monkeypatch, OrnsteinUhlenbeckProcess)
    jax_noise = _recorded_samples(monkeypatch, JaxOU)
    port = bounded_actor_run(_opt(tmp_path, "pipelined"), ticks,
                             process_ind=1)["stream"]
    ref = [t for t, _p in jax_actor.bounded_actor_run(
        jopt, ticks, process_ind=1)["stream"]]
    assert len(port_noise) == len(jax_noise) == ticks
    for x, y in zip(port_noise, jax_noise):
        np.testing.assert_array_equal(x, y)
    assert len(port) == len(ref) > ticks
    for t1, t2 in zip(port, ref):
        for f in REPLAY_FIELDS:
            np.testing.assert_allclose(
                np.asarray(getattr(t1, f), np.float64),
                np.asarray(getattr(t2, f), np.float64), rtol=1e-5,
                atol=1e-5, err_msg=f)


def test_greedy_return_matches_the_reference():
    jopt = jax_options(16)
    jspec = jax_probe_env(jopt)
    jmodel = jax_build_model(jopt, jspec)
    jparams = jax_init_params(jopt, jspec, jmodel, seed=5)
    opt = build_options(16, device="cpu")
    spec = probe_env(opt)
    slot = 9
    jenv, env = JaxReacher(jopt.env_params, slot), ReacherEnv(opt.env_params,
                                                               slot)
    jenv.eval()
    env.eval()
    ref = jax_greedy_episodes(jopt, jspec, jmodel, jparams, jenv, 2)
    got = greedy_episodes(opt, spec, build_model(opt, spec),
                          convert_ddpg_mlp(jax.device_get(jparams)), env, 2)
    assert got[0] == ref[0] == 150.0 and got[2] == ref[2]
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-4)


@pytest.mark.parametrize("backend", ["device", "anakin"])
def test_device_backends_step_down_to_pipelined(tmp_path, backend):
    opt = _opt(tmp_path, backend, config=2)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert resolve_actor_backend(opt) == "pipelined"
    assert any("falling back to pipelined" in str(x.message) for x in w)
