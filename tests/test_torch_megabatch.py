"""The port's megabatch group step and its fused dispatches against the JAX
package's, with the oracles of ``tests/test_megabatch.py``, on a narrow
``dqn-cnn`` (44x44 frames) converted from the same flax params and the
same numpy batches, in fp32:

- the group step (M = 4) against ``build_dqn_megabatch_step``: params,
  Adam moments, target, step, |TD|, ``ok`` and the metrics, through the
  module's forward and through the GEMM torso (its plain version here; the
  JAX group step runs ``build_pallas_torso_apply`` in interpret mode);
- M = 1 equals the port's sequential step: to the bit through the GEMM
  torso; through the module's forward, which runs under ``vmap`` as at
  M > 1, within rtol 1e-5 (the conv biases' gradients are summed in
  another order: 2e-6 relative at most over two updates); a run with
  ``megabatch=1`` builds no group step at all;
- a poisoned middle minibatch skips its own update only, as the JAX step
  does; an all-poisoned group passes the state through unchanged;
- the fused PER dispatch (K = 4, M = 2) against the JAX fused step on the
  same ring, the draw through the Pallas kernel in interpret mode:
  priorities, their running max, params and step;
- the uniform dispatch (K = 4, M = 2) against the JAX one: the gather at
  the JAX package's own indices, the dispatch at uniforms ``(idx + 0.5) /
  fill``;
- ``per_apply_writeback_groups``: ordered groups whose indices collide
  land last-group-wins, as the JAX package's;
- ``resolve_megabatch``'s rounding, the ``TPU_APEX_MXU_*`` overrides and
  a family without a group step.

Tolerances: rtol 1e-4 with atol 1e-5 on params and moments (the same fp32
math in another summation order; Adam maps a near-zero gradient's noise
to at most about lr/100) and on what a dispatch's later updates compute
from those params (their losses and the priorities they write); rtol
1e-5 on the group step's |TD| and metrics."""

import functools

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
    per_apply_writeback_groups as jax_writeback_groups,
)
from pytorch_distributed_tpu.memory.device_replay import (
    DeviceReplay as JaxDeviceReplay,
    build_uniform_fused_step as jax_uniform_fused,
    sample_rows as jax_sample_rows,
)
from pytorch_distributed_tpu.ops.pallas_sampling import hierarchical_sample
from pytorch_distributed_tpu.utils.experience import (
    Batch as JaxBatch, Transition as JaxTransition,
)
from pytorch_distributed_tpu_torch.config import build_options
from pytorch_distributed_tpu_torch.convert import convert_dqn_cnn
from pytorch_distributed_tpu_torch.factory import (
    EnvSpec, build_megabatch_train_step, build_model,
    build_train_state_and_step, resolve_fused_step, resolve_megabatch,
)
from pytorch_distributed_tpu_torch.memory.device_per import (
    DevicePerReplay, per_apply_writeback_groups,
)
from pytorch_distributed_tpu_torch.memory.device_replay import (
    DeviceReplay, sample_rows, uniform_index,
)
from pytorch_distributed_tpu_torch.ops import cuda_torso
from pytorch_distributed_tpu_torch.ops.losses import SKIPPED_KEY
from pytorch_distributed_tpu_torch.utils.experience import (
    REPLAY_FIELDS, Batch, Transition,
)
from pytorch_distributed_tpu_torch.utils.perf import resolve_mxu

FRAME = (4, 44, 44)  # conv stack 10x10 -> 4x4 -> 2x2
ACTIONS, B, M = 6, 4, 4
CAPACITY, ROWS = 128, 100
OVERRIDES = dict(compute_dtype="float32", target_model_update=3)  # lr 1e-4
TOL = dict(rtol=1e-4, atol=1e-5)
TIGHT = dict(rtol=1e-5, atol=1e-6)


@functools.lru_cache(maxsize=None)  # every step is pure: safe to share
def _setups(torso: str):
    extra = ({"pallas_torso": True} if torso == "kernel" else {})
    jopt = jax_options(12, pallas_interpret=True, **OVERRIDES, **extra)
    jspec = JaxEnvSpec(state_shape=FRAME, discrete=True,
                       num_actions=ACTIONS, action_dim=0, norm_val=255.0)
    jmodel = jax_build_model(jopt, jspec)
    jparams = jax_init_params(jopt, jspec, jmodel, seed=0)
    jstate, jstep = jax_state_and_step(jopt, jspec, jmodel, jparams)
    jmega = jax_mega_step(jopt, jmodel)

    opt = build_options(12, device="cpu", **OVERRIDES, **extra)
    model = build_model(opt, EnvSpec(FRAME, ACTIONS, 255.0))
    state, step = build_train_state_and_step(
        opt, model, convert_dqn_cnn(jax.device_get(jparams), FRAME))
    mega = build_megabatch_train_step(opt, model)
    return (jstate, jstep, jax.jit(jmega)), (state, step, mega)


def _batches(m: int, seed: int, poison=()):
    rng = np.random.default_rng(seed)
    cols = dict(
        state0=rng.integers(0, 255, (m, B, *FRAME)).astype(np.uint8),
        action=rng.integers(0, ACTIONS, (m, B)).astype(np.int32),
        reward=rng.normal(size=(m, B)).astype(np.float32),
        gamma_n=np.full((m, B), 0.99 ** 5, np.float32),
        state1=rng.integers(0, 255, (m, B, *FRAME)).astype(np.uint8),
        terminal1=(rng.random((m, B)) < 0.3).astype(np.float32),
        weight=rng.uniform(0.2, 1.0, (m, B)).astype(np.float32),
        index=np.tile(np.arange(B, dtype=np.int32), (m, 1)))
    for i in poison:
        cols["reward"][i, 1] = np.nan
    return (JaxBatch(**cols),
            Batch(**{k: torch.from_numpy(v.copy()) for k, v in cols.items()}))


def _close(port: dict, ref_tree, what: str, **tol):
    ref = convert_dqn_cnn(jax.device_get(ref_tree), FRAME)
    for k, v in ref.items():
        np.testing.assert_allclose(port[k].numpy(), v.numpy(),
                                   err_msg=f"{what} {k}", **(tol or TOL))


def _compare_state(jstate, state, **tol):
    adam = jstate.opt_state[0][0]
    _close(state.params, jstate.params, "params", **tol)
    _close(state.target_params, jstate.target_params, "target", **tol)
    _close(state.opt_state.mu, adam.mu, "adam mu", **tol)
    _close(state.opt_state.nu, adam.nu, "adam nu", **tol)
    assert int(state.opt_state.count) == int(adam.count)
    assert int(state.step) == int(jstate.step)


def _tree_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return all(_tree_equal(a[k], b[k]) for k in a)
    return all(_tree_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("torso", ["module", "kernel"])
def test_group_step_matches_jax(torso):
    (jstate, _jstep, jmega), (state, _step, mega) = _setups(torso)
    for g in range(2):  # two groups: 8 updates, the target synced twice
        jb, tb = _batches(M, seed=g)
        jstate, jm, jtd, jok = jmega(jstate, jb)
        state, m, td, ok = mega(state, tb)
        np.testing.assert_allclose(td.numpy(), np.asarray(jtd), **TIGHT)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
        for key in ("learner/critic_loss", "learner/q_mean",
                    "learner/grad_norm", SKIPPED_KEY):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-5, atol=1e-7, err_msg=key)
    _compare_state(jstate, state)
    assert int(state.step) == 2 * M


@pytest.mark.parametrize("torso", ["module", "kernel"])
def test_one_minibatch_group_is_the_sequential_step(torso):
    _jax, (state, step, mega) = _setups(torso)
    for seed in range(2):
        _jb, tb = _batches(1, seed=seed)
        one = Batch(*(f[0] for f in tb))
        s_seq, m_seq, td_seq = step(state, one)
        s_grp, m_grp, td_grp, ok = mega(state, tb)
        assert set(m_seq) == set(m_grp)
        assert ok.tolist() == [1.0]
        assert int(s_grp.step) == int(s_seq.step)
        if torso == "kernel":
            assert _tree_equal(s_seq, s_grp)
            assert torch.equal(td_seq, td_grp[0])
            for k in m_seq:
                assert torch.equal(m_seq[k], m_grp[k]), k
        else:  # the vmap forward: fp32 in another summation order
            for tree in ("params", "target_params"):
                for k, v in getattr(s_seq, tree).items():
                    np.testing.assert_allclose(
                        getattr(s_grp, tree)[k].numpy(), v.numpy(),
                        err_msg=f"{tree} {k}", **TIGHT)
            for a, b in ((s_grp.opt_state.mu, s_seq.opt_state.mu),
                         (s_grp.opt_state.nu, s_seq.opt_state.nu)):
                for k in b:
                    np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                               err_msg=k, **TIGHT)
            np.testing.assert_allclose(td_grp[0].numpy(), td_seq.numpy(),
                                       **TIGHT)
            for k in m_seq:
                np.testing.assert_allclose(float(m_grp[k]), float(m_seq[k]),
                                           err_msg=k, **TIGHT)
        state = s_seq


def test_group_products_run_through_the_kernel_wrapper():
    """The kernel torso's group step: one product a layer for the forward
    (the online and the target net), one ``dx`` product a layer but the
    first, and one ``dw`` product a layer and minibatch, all through
    ``gemm`` (its plain version on the CPU)."""
    _jax, (state, _step, mega) = _setups("kernel")
    _jb, tb = _batches(M, seed=3)
    calls = []
    real = cuda_torso.gemm
    cuda_torso.gemm = lambda a, b, grad=False: (calls.append(grad),
                                                real(a, b, grad))[1]
    try:
        mega(state, tb)
    finally:
        cuda_torso.gemm = real
    assert calls.count(False) == 10 and calls.count(True) == 4 + 5 * M


def test_poisoned_minibatch_skips_only_its_update():
    (jstate, _jstep, jmega), (state, _step, mega) = _setups("module")
    jb, tb = _batches(M, seed=5, poison=(1,))
    jstate, jm, jtd, jok = jmega(jstate, jb)
    state, m, td, ok = mega(state, tb)
    assert ok.tolist() == np.asarray(jok).tolist() == [1.0, 0.0, 1.0, 1.0]
    assert float(m[SKIPPED_KEY]) == float(jm[SKIPPED_KEY]) == 1.0
    assert not td[1].any()
    np.testing.assert_allclose(td.numpy(), np.asarray(jtd), **TIGHT)
    _compare_state(jstate, state)
    assert int(state.step) == M - 1


def test_all_poisoned_group_passes_the_state_through():
    _jax, (state, _step, mega) = _setups("module")
    _jb, tb = _batches(M, seed=6, poison=range(M))
    new, m, td, ok = mega(state, tb)
    assert not ok.any() and float(m[SKIPPED_KEY]) == M
    assert not td.any()
    assert _tree_equal(new, state)


def _chunk(seed: int = 0):
    rng = np.random.default_rng(seed)
    return dict(
        state0=rng.integers(0, 255, (ROWS, *FRAME)).astype(np.uint8),
        action=rng.integers(0, ACTIONS, ROWS).astype(np.int32),
        reward=rng.normal(size=ROWS).astype(np.float32),
        gamma_n=np.full(ROWS, 0.99 ** 5, np.float32),
        state1=rng.integers(0, 255, (ROWS, *FRAME)).astype(np.uint8),
        terminal1=(rng.random(ROWS) < 0.1).astype(np.float32))


def test_fused_per_dispatch_matches_jax():
    (jstate, jstep, _jmega), (state, step, _mega) = _setups("module")
    jopt = jax_options(12, pallas_interpret=True, megabatch=2, **OVERRIDES)
    opt = build_options(12, device="cpu", megabatch=2, **OVERRIDES)
    jspec = JaxEnvSpec(state_shape=FRAME, discrete=True,
                       num_actions=ACTIONS, action_dim=0, norm_val=255.0)
    jmega = jax_mega_step(jopt, jax_build_model(jopt, jspec))
    mega = build_megabatch_train_step(
        opt, build_model(opt, EnvSpec(FRAME, ACTIONS, 255.0)))
    cols = _chunk()
    jring = JaxDevicePerReplay(CAPACITY, FRAME)
    jring.feed_chunk(JaxTransition(**cols))
    jring._draw_fn = functools.partial(hierarchical_sample, interpret=True)
    ring = DevicePerReplay(CAPACITY, FRAME, device="cpu")
    ring.feed_chunk(Transition(**cols))
    K = 4
    jfused = jring.build_fused_step(jstep, B, donate=False, steps_per_call=K,
                                    megabatch=2, megabatch_step=jmega)
    fused = ring.build_fused_step(step, B, steps_per_call=K, megabatch=2,
                                  megabatch_step=mega)
    beta = ring.beta(0)
    for dispatch in range(2):
        keys = jax.random.split(jax.random.PRNGKey(dispatch), K)
        jstate, jring.state, jm = jfused(jstate, jring.state, keys,
                                         np.float32(beta))
        us = torch.from_numpy(np.stack(
            [np.array(jax.random.uniform(k, (B,))) for k in keys]))
        state, m = fused(state, ring.state, us, beta)
        np.testing.assert_allclose(float(m["learner/critic_loss"]),
                                   float(jm["learner/critic_loss"]),
                                   rtol=1e-4)
    _close(state.params, jstate.params, "params")
    np.testing.assert_allclose(ring.state.priority.numpy(),
                               np.asarray(jring.state.priority), **TOL)
    np.testing.assert_allclose(float(ring.state.max_priority),
                               float(jring.state.max_priority), rtol=1e-4)
    assert int(state.step) == int(jstate.step) == 2 * K
    assert (ring.state.priority[:ROWS] != 1.0).sum() >= B


def test_uniform_dispatch_matches_jax():
    (jstate, jstep, jmega), (state, step, mega) = _setups("module")
    cols = _chunk(seed=1)
    jring = JaxDeviceReplay(CAPACITY, FRAME)
    jring.feed_chunk(JaxTransition(**cols))
    ring = DeviceReplay(CAPACITY, FRAME, device="cpu")
    ring.feed_chunk(Transition(**cols))
    K = 4
    jfused = jax_uniform_fused(jstep, B, steps_per_call=K, donate=False,
                               megabatch=2, megabatch_step=jmega)
    fused = ring.build_fused_step(step, B, steps_per_call=K, megabatch=2,
                                  megabatch_step=mega)
    keys = jax.random.split(jax.random.PRNGKey(7), K)
    idx = np.stack([np.asarray(jax.random.randint(k, (B,), 0, ROWS))
                    for k in keys])
    # the gather at the JAX package's own indices
    jb = jax_sample_rows(jring.state, keys[0], B)
    tb = sample_rows(ring.state, torch.from_numpy(idx[0]).long())
    for f in REPLAY_FIELDS + ("weight",):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    # the draw at uniforms in the middle of each row's interval
    us = torch.from_numpy(((idx + 0.5) / ROWS).astype(np.float32))
    assert torch.equal(uniform_index(ring.state, us[0]),
                       torch.from_numpy(idx[0]).long())
    jstate, jm = jfused(jstate, jring.state, keys)
    state, m = fused(state, ring.state, us)
    np.testing.assert_allclose(float(m["learner/critic_loss"]),
                               float(jm["learner/critic_loss"]), rtol=1e-4)
    _compare_state(jstate, state)
    assert int(state.step) == K


def test_writeback_groups_land_in_order_like_jax():
    cols = _chunk(seed=2)
    jring = JaxDevicePerReplay(CAPACITY, FRAME)
    jring.feed_chunk(JaxTransition(**cols))
    ring = DevicePerReplay(CAPACITY, FRAME, device="cpu")
    ring.feed_chunk(Transition(**cols))
    rng = np.random.default_rng(3)
    groups = [(rng.integers(0, 20, 16).astype(np.int32),
               rng.uniform(0.0, 3.0, 16).astype(np.float32))
              for _ in range(3)]  # 48 draws of 20 rows: collisions
    jstate = jax_writeback_groups(jring.state, groups, jring.alpha)
    per_apply_writeback_groups(ring.state, groups, ring.alpha)
    np.testing.assert_allclose(ring.state.priority.numpy(),
                               np.asarray(jstate.priority), **TIGHT)
    assert float(ring.state.max_priority) == pytest.approx(
        float(jstate.max_priority), rel=1e-6)


def test_resolve_megabatch_and_the_overrides(monkeypatch, capsys):
    opt = build_options(12, device="cpu", megabatch=4)
    assert resolve_megabatch(opt, 6) == (4, 8)
    assert "rounded up to 8 (multiple of megabatch 4)" in \
        capsys.readouterr().out
    assert resolve_megabatch(opt, 8) == (4, 8)
    assert resolve_megabatch(build_options(12, device="cpu"), 3) == (1, 3)
    # megabatch=1 runs the sequential step itself: no group step is built
    one = build_options(12, device="cpu", steps_per_dispatch=3)
    assert resolve_fused_step(
        one, build_model(one, EnvSpec(FRAME, ACTIONS, 255.0)), "test") == \
        (1, 3, None)
    monkeypatch.setenv("TPU_APEX_MXU_MEGABATCH", "2")
    monkeypatch.setenv("TPU_APEX_MXU_PALLAS_TORSO", "true")
    lp = resolve_mxu(opt.learner_perf_params)
    assert (lp.megabatch, lp.pallas_torso) == (2, True)
    assert opt.learner_perf_params.megabatch == 4  # the input is unchanged
    assert resolve_megabatch(opt, 3) == (2, 4)
    # a family without a group step: none is built
    ddpg = build_options(1, device="cpu")
    ddpg.agent_type = "ddpg"
    assert build_megabatch_train_step(
        ddpg, build_model(ddpg, EnvSpec((8,), 2, 1.0))) is None
