"""The port's C++ Pong stepper (``envs/native_pong.py`` over
``native/pong_batch.cpp``, built by ``utils/native_build.py``) against the
JAX package's wrapper of the same source, and its dynamics against the
port's numpy ``PongSimEnv``; the factory's routing; a build that cannot
run raises.  Everything here is exact: integer frames, float32 rewards and
doubles stepped in the same order."""

import os

import numpy as np
import pytest

from pytorch_distributed_tpu.config import EnvParams as JaxEnvParams
from pytorch_distributed_tpu.envs.native_pong import (
    NativePongVectorEnv as JaxNativePong,
)
from pytorch_distributed_tpu_torch.config import EnvParams, build_options
from pytorch_distributed_tpu_torch.envs import native_pong
from pytorch_distributed_tpu_torch.envs.native_pong import NativePongVectorEnv
from pytorch_distributed_tpu_torch.envs.pong_sim import PongSimEnv
from pytorch_distributed_tpu_torch.envs.vector import VectorEnv
from pytorch_distributed_tpu_torch.factory import (
    build_env_vector, prebuild_native,
)
from pytorch_distributed_tpu_torch.utils import native_build

PARAMS = dict(env_type="pong-sim", seed=11, state_cha=4, early_stop=60,
              action_repetition=4)


def test_steps_like_the_jax_packages_wrapper():
    """4 envs of actor 2, 320 ticks of seeded actions: with early_stop 60
    every env truncates and resets several times."""
    ours = NativePongVectorEnv(EnvParams(**PARAMS), process_ind=2,
                               num_envs=4)
    theirs = JaxNativePong(JaxEnvParams(**PARAMS), process_ind=2, num_envs=4)
    np.testing.assert_array_equal(ours.reset(), theirs.reset())
    actions = np.random.default_rng(5).integers(0, 6, (320, 4))
    finals = truncs = 0
    for acts in actions:
        o, r, t, infos = ours.step(acts)
        jo, jr, jt, jinfos = theirs.step(acts)
        np.testing.assert_array_equal(o, jo)
        assert r.dtype == jr.dtype and np.array_equal(r, jr)
        np.testing.assert_array_equal(t, jt)
        for info, jinfo in zip(infos, jinfos):
            assert info.keys() == jinfo.keys()
            assert info["score"] == jinfo["score"]
            assert info.get("truncated") == jinfo.get("truncated")
            if "final_obs" in info:
                np.testing.assert_array_equal(info["final_obs"],
                                              jinfo["final_obs"])
                finals += 1
            truncs += bool(info.get("truncated"))
    assert finals >= 4 * 5 and truncs >= 4 * 5
    for i in range(4):
        np.testing.assert_array_equal(ours.get_state(i), theirs.get_state(i))
        np.testing.assert_array_equal(ours.render_frame(i),
                                      theirs.render_frame(i))


def test_dynamics_match_the_numpy_simulator():
    """The same mid-court rally state on both, then the same actions: with
    no point scored, no generator draw enters, and frames and rewards must
    agree to the bit (reference tests/test_native_pong.py:71-101)."""
    params = EnvParams(**dict(PARAMS, early_stop=12500))
    sim = PongSimEnv(params, process_ind=0)
    sim.reset()
    nat = NativePongVectorEnv(params, 0, 1)
    nat.reset()
    sim.player_y, sim.enemy_y = 30.0, 55.0
    sim.ball_x, sim.ball_y = 42.0, 40.0
    sim.ball_vx, sim.ball_vy = -1.4, 0.3
    sim._score = [0, 0]
    nat.set_state(0, np.array([30.0, 55.0, 42.0, 40.0, -1.4, 0.3, 0, 0]))
    np.testing.assert_array_equal(sim._draw(), nat.render_frame(0))
    for t, a in enumerate([2, 3, 0, 5, 4, 1, 2, 2, 3, 0, 1, 4]):
        obs, r, term, _ = sim.step(a)
        nobs, nr, nterm, _ = nat.step([a])
        assert r == 0.0 and nr[0] == 0.0, "a point would draw a serve"
        assert not term and not nterm[0]
        np.testing.assert_array_equal(obs[-1], nobs[0, -1])
        if t >= 3:  # the whole stack is the new frames by now
            np.testing.assert_array_equal(obs, nobs[0])
    state = nat.get_state(0)
    np.testing.assert_array_equal(
        state[:6], [sim.player_y, sim.enemy_y, sim.ball_x, sim.ball_y,
                    sim.ball_vx, sim.ball_vy])


@pytest.mark.parametrize("native", [True, False])
def test_factory_routes_pong_to_the_stepper(native):
    opt = build_options(12, device="cpu", native_env=native)
    env = build_env_vector(opt, process_ind=1, num_envs=3)
    assert isinstance(env, NativePongVectorEnv if native else VectorEnv)
    obs = env.reset()
    assert obs.shape == (3, 4, 84, 84) and obs.dtype == np.uint8
    assert build_options(12).env_params.native_env is True


@pytest.mark.parametrize("fault", ["missing_compiler", "failing_compile"])
def test_a_build_that_cannot_run_raises(tmp_path, monkeypatch, fault):
    """Into an empty build directory, so the library on disk is not
    reused; the factory raises rather than fall back to numpy."""
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native_pong, "_lib", None)
    if fault == "missing_compiler":
        monkeypatch.setattr(native_build, "CXX", "no-such-compiler-g++")
        match = "could not build"
    else:
        monkeypatch.setattr(native_build, "CXX_FLAGS",
                            native_build.CXX_FLAGS + ("-no-such-flag",))
        match = "failed for pong_batch"
    opt = build_options(12, device="cpu")
    with pytest.raises(native_build.NativeBuildError, match=match):
        prebuild_native(opt)
    with pytest.raises(native_build.NativeBuildError, match=match):
        build_env_vector(opt, 0, 2)
    assert os.listdir(tmp_path) == []  # no temporary file left behind
    # the explicit numpy path needs no compiler
    assert isinstance(build_env_vector(build_options(
        12, device="cpu", native_env=False), 0, 2), VectorEnv)
