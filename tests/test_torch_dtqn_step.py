"""The port's DTQN update (ops/sequence_losses.build_dtqn_train_step)
against the JAX package's (pytorch_distributed_tpu/ops/sequence_losses.py
``build_dtqn_train_step``) for each transformer family, on the same
weights (``convert.convert_dtqn``) and the same numpy segment batches, at
a small size (dim 32, 4 heads, depth 2, segments of 8 steps: a window of
9, chain obs of 8; the MoE with 4 experts, top-2, capacity factor 1.0,
aux weight 0.01), with burn-in 0 as the factories force it:

- three chained updates on segments with masked tails, terminals and IS
  weights, double DQN, the target copied every 2 steps: the loss (the MoE
  aux term included), q_mean, grad norm and ``learner/moe_aux`` of each
  update and the sequence priorities within rtol 1e-4 and atol 1e-5;
  after them each leaf's Adam first moment within 1e-3 of the
  reference's norm of that leaf (the same fp32 math in another summation
  order), and each leaf of the params and target params within 1e-3 of
  the distance the reference's moved over the three updates (Adam's
  normalised step magnifies an element's rounding where its gradient is
  small: the worst leaf reads 1.7e-4), but for the keys' bias: softmax
  is shift-invariant, so its gradient is rounding noise (first moments
  under 1e-6 on both sides, checked), which Adam turns into steps of lr
  with either sign;
  the MoE's routing margins stay above 1e-4 in logits on every pass
  (checked), so no token's route can flip between the packages;
- the factory's r2d2 branch builds this step with burn-in 0 for rows 15,
  17 and 18 and the MoE's (q, aux) apply for row 17;
- a guard-skipped update (a NaN reward): ``learner/skipped`` 1, the state
  unchanged, the priorities zero, as the JAX step;
- ``bench_learner`` times row 17's update on the host ring (eager) and on
  the device segment ring (fused), with no kernel of ours launched."""

import numpy as np
import pytest

import jax
import torch

from pytorch_distributed_tpu.memory.sequence_replay import (
    SegmentBatch as JaxSegmentBatch,
)
from pytorch_distributed_tpu.models.moe import window_q_with_aux
from pytorch_distributed_tpu.ops import losses as jlosses
from pytorch_distributed_tpu.ops import sequence_losses as jsl
from pytorch_distributed_tpu_torch.config import build_options
from pytorch_distributed_tpu_torch.convert import convert_dtqn
from pytorch_distributed_tpu_torch.factory import (
    EnvSpec, build_model, build_train_state_and_step, init_params,
)
from pytorch_distributed_tpu_torch.memory.sequence_replay import (
    SegmentBatch,
)
from pytorch_distributed_tpu_torch.models import moe as moe_mod
from pytorch_distributed_tpu_torch.ops.losses import (
    SKIPPED_KEY, init_train_state, make_optimizer,
)
from pytorch_distributed_tpu_torch.ops.sequence_losses import (
    build_dtqn_train_step,
)

from test_torch_dtqn import MIN_MARGIN, _pair

OBS, B, T, NSTEP, LR, AUX = 8, 4, 8, 3, 1e-3, 0.01
TOL = dict(rtol=1e-4, atol=1e-5)
METRICS = ("learner/critic_loss", "learner/q_mean", "learner/grad_norm")
# the qkv bias leaves, whose middle third (the keys' bias, dim 32) shifts
# every score of a query alike
_KEY_BIAS = lambda k: k.endswith(("qkv.bias", "qkv_b"))


def _segments(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    n_valid = rng.integers(T // 2, T + 1, B)
    mask = (np.arange(T)[None, :] < n_valid[:, None]).astype(np.float32)
    return dict(
        obs=rng.normal(size=(B, T + 1, OBS)).astype(np.float32),
        action=rng.integers(0, 3, (B, T)).astype(np.int32),
        reward=(rng.normal(size=(B, T)) * 3.0 * mask).astype(np.float32),
        terminal=((rng.random((B, T)) < 0.1) * mask).astype(np.float32),
        mask=mask, c0=np.zeros((B, 1), np.float32),
        h0=np.zeros((B, 1), np.float32),
        weight=rng.uniform(0.2, 1.0, B).astype(np.float32),
        index=np.arange(B, dtype=np.int32))


def _port_batch(d: dict) -> SegmentBatch:
    return SegmentBatch(**{k: torch.from_numpy(v) for k, v in d.items()})


def _steps(family: str, seed: int):
    jm, jp, tm, p = _pair(family, seed=seed)
    kw = dict(burn_in=0, nstep=NSTEP, gamma=0.99, enable_double=True,
              target_model_update=2, rescale_values=True, priority_eta=0.9,
              guard=True)
    jkw, tkw = dict(kw), dict(kw)
    if family == "moe":
        japply = window_q_with_aux(jm)
        jkw.update(aux_weight=AUX, target_window_apply=lambda q, o: jm.apply(
            q, o, method=jm.window_q))
        tapply = tm.window_q_with_aux
        tkw.update(aux_weight=AUX, target_window_apply=tm.window_q)
    else:
        japply = lambda q, o: jm.apply(q, o, method=jm.window_q)
        tapply = tm.window_q
    jtx = jlosses.make_optimizer(LR)
    jstate = jlosses.init_train_state(jp, jtx)
    jstep = jax.jit(jsl.build_dtqn_train_step(japply, jtx, **jkw))
    step = build_dtqn_train_step(tapply, make_optimizer(LR), **tkw)
    return jstate, jstep, init_train_state(p), step


def _tree(jtree) -> dict:
    return convert_dtqn(jax.tree_util.tree_map(np.asarray, jtree))


@pytest.mark.parametrize("family", ["mlp", "moe", "pipe"])
def test_step_matches_jax_over_three_updates(family, monkeypatch):
    least = [float("inf")]
    inner = moe_mod.top_k_dispatch

    def spy(probs, k, capacity):
        s = torch.sort(probs.detach().double(), -1, descending=True
                       ).values.log()
        least[0] = min(least[0], float((s[..., k - 1] - s[..., k]).min()),
                       float((s[..., 0] - s[..., 1]).min()))
        return inner(probs, k, capacity)

    monkeypatch.setattr(moe_mod, "top_k_dispatch", spy)
    jstate, jstep, state, step = _steps(family, seed=11)
    start_p = {k: v.clone() for k, v in state.params.items()}
    for i in range(3):
        d = _segments(20 + i)
        jstate, jm, jpr = jstep(jstate, JaxSegmentBatch(**d))
        state, m, pr = step(state, _port_batch(d))
        keys = METRICS + (("learner/moe_aux",) if family == "moe" else ())
        assert ("learner/moe_aux" in m) == (family == "moe")
        for k in keys:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=k,
                                       **TOL)
        assert float(m[SKIPPED_KEY]) == float(jm[SKIPPED_KEY]) == 0.0
        np.testing.assert_allclose(pr.numpy(), np.asarray(jpr), **TOL)
    assert int(state.step) == int(jstate.step) == 3
    adam = jstate.opt_state[0][0]  # chain(adam) -> ScaleByAdamState
    for k, want in _tree(adam.mu).items():
        got = state.opt_state.mu[k].double()
        want = want.double()
        assert float((got - want).norm()) <= 1e-3 * float(want.norm()) \
            + 1e-12, k
        if _KEY_BIAS(k):  # no gradient, as softmax is shift-invariant
            assert float(got[..., 32:64].abs().max()) < 1e-6, k
            assert float(want[..., 32:64].abs().max()) < 1e-6, k
    for port, jtree in ((state.params, jstate.params),
                        (state.target_params, jstate.target_params)):
        for k, v in _tree(jtree).items():
            got, want, s0 = (x.double().numpy()
                             for x in (port[k], v, start_p[k]))
            if _KEY_BIAS(k):
                # Adam normalises the key bias's rounding-noise gradient
                # into steps of lr and either sign on both sides
                got, want, s0 = (np.delete(x, np.s_[32:64], axis=-1)
                                 for x in (got, want, s0))
            assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(
                want - s0), k
    if family == "moe":
        assert least[0] > MIN_MARGIN


@pytest.mark.parametrize("config", [15, 17, 18])
def test_factory_builds_the_dtqn_step(config):
    opt = build_options(config, device="cpu", tf_dim=32, seq_len=T,
                        burn_in=40, batch_size=B)
    spec = EnvSpec((OBS,), 3, 1.0)
    model = build_model(opt, spec, init_weights=False)
    state, step = build_train_state_and_step(
        opt, model, init_params(opt, spec, seed=0))
    d = _segments(40)
    state, m, pr = step(state, _port_batch(d))  # burn_in 40 > T: forced 0
    assert pr.shape == (B,) and torch.isfinite(pr).all()
    assert ("learner/moe_aux" in m) == (config == 17)
    assert float(m[SKIPPED_KEY]) == 0.0


@pytest.mark.parametrize("family", ["mlp", "moe"])
def test_guard_skips_a_nan_update_like_jax(family):
    jstate, jstep, state, step = _steps(family, seed=12)
    d = _segments(30)
    d["reward"][1, 3] = np.nan
    d["mask"][1, 3] = 1.0
    jnew, jm, jpr = jstep(jstate, JaxSegmentBatch(**d))
    new, m, pr = step(state, _port_batch(d))
    assert float(m[SKIPPED_KEY]) == float(jm[SKIPPED_KEY]) == 1.0
    assert not pr.any() and not np.asarray(jpr).any()
    assert int(new.step) == int(jnew.step) == 0
    for k, v in state.params.items():
        assert torch.equal(new.params[k], v)
        assert torch.equal(new.opt_state.mu[k], state.opt_state.mu[k])


@pytest.mark.parametrize("memory_type", ["sequence", "device-sequence"])
def test_bench_learner_times_the_dtqn_update(memory_type):
    """``bench_learner`` runs row 17's update on the row's host ring (the
    eager update the learner runs there) and on the device segment ring
    (the fused dispatch); no kernel of ours launches."""
    from pytorch_distributed_tpu_torch import bench_learner

    out = bench_learner.run(build_options(
        17, device="cpu", memory_type=memory_type, tf_dim=32, seq_len=T,
        batch_size=B, memory_size=256, moe_experts=4), updates=3)
    assert out["memory_type"] == memory_type and out["updates"] == 3
    assert out["compute_dtype"] == "float32"
    assert not any(out["launches_per_update"].values())
    assert out["updates_per_sec"] > 0
