"""The port's DDPG model and updates against the JAX package's, on the same
weights (carried across by ``convert.convert_ddpg_mlp``) and the same
numpy batches, in fp32:

- ``forward_actor`` and ``forward_critic`` against flax for d = 1, 2 and
  6 (rtol 1e-5, atol 1e-6), the published vector in the reference's
  ``ravel_pytree`` layout exactly, and the port's own init with the
  reference's ranges and per-layer spread;
- the decoupled and the coupled steps against the JAX steps (optax) over
  5 updates at ``clip_grad`` 40 and tau 1e-3: params, targets, both Adam
  moments and counts, |TD| and the metrics, within rtol 1e-4 and atol
  1e-5 (the same fp32 math in another summation order; Adam maps a
  near-zero gradient's noise to at most about lr/100);
- ``lr_decay`` and ``weight_decay`` on the dqn step (row 1's MLP)
  against optax's chain, and ``lr_decay`` on DDPG's two optimizers;
- ``_value_loss`` (squared error or Huber) against the reference's;
- the megabatch group step at M = 4 against the JAX group step (rtol
  1e-4, atol 5e-5: the tolerance the JAX package's own group test holds
  DDPG to), M = 1 against the sequential step, and a minibatch whose
  actor stage alone is non-finite: its critic update kept, its actor,
  target and step skipped, its |TD| zeroed."""

import functools

import numpy as np
import pytest

import jax
import torch
from jax.flatten_util import ravel_pytree

from pytorch_distributed_tpu.config import build_options as jax_options
from pytorch_distributed_tpu.factory import (
    EnvSpec as JaxEnvSpec, build_megabatch_train_step as jax_mega_step,
    build_model as jax_build_model,
    build_train_state_and_step as jax_state_and_step,
    init_params as jax_init_params,
)
from pytorch_distributed_tpu.models.ddpg_mlp import DdpgMlpModel as JaxDdpg
from pytorch_distributed_tpu.utils.experience import Batch as JaxBatch
from pytorch_distributed_tpu_torch.agents.param_store import flatten_into
from pytorch_distributed_tpu_torch.config import build_options
from pytorch_distributed_tpu_torch.convert import (
    convert_ddpg_mlp, convert_dqn_mlp,
)
from pytorch_distributed_tpu_torch.factory import (
    EnvSpec, build_megabatch_train_step, build_model,
    build_train_state_and_step, ddpg_applies, make_optimizers,
    published_params,
)
from pytorch_distributed_tpu_torch.models.ddpg_mlp import DdpgMlpModel
from pytorch_distributed_tpu_torch.ops.losses import (
    SKIPPED_KEY, build_ddpg_megabatch_step,
)
from pytorch_distributed_tpu_torch.utils.experience import Batch

OBS, ACT, B = 10, 2, 16
TOL = dict(rtol=1e-4, atol=1e-5)
GROUP_TOL = dict(rtol=1e-4, atol=5e-5)
METRICS = ("learner/critic_loss", "learner/actor_loss", "learner/grad_norm")


@pytest.mark.parametrize("d", [1, 2, 6])
def test_forward_and_layout_match_flax(d):
    jmodel = JaxDdpg(action_dim=d)
    jparams = jmodel.init(jax.random.PRNGKey(d), np.zeros((1, OBS),
                                                          np.float32))
    sd = convert_ddpg_mlp(jax.device_get(jparams))
    model = DdpgMlpModel(d, OBS)
    model.load_state_dict(sd)
    rng = np.random.default_rng(d)
    obs = rng.normal(size=(32, OBS)).astype(np.float32)
    act = rng.uniform(-1, 1, (32, d)).astype(np.float32)
    with torch.no_grad():
        a = model.forward_actor(torch.from_numpy(obs)).numpy()
        q = model.forward_critic(torch.from_numpy(obs),
                                 torch.from_numpy(act)).numpy()
    np.testing.assert_allclose(a, np.asarray(jmodel.apply(
        jparams, obs, method=jmodel.forward_actor)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(q, np.asarray(jmodel.apply(
        jparams, obs, act, method=jmodel.forward_critic)), rtol=1e-5,
        atol=1e-6)
    assert q.shape == (32,) and a.shape == (32, d)
    flat = flatten_into(sd, torch.empty(sum(v.numel() for v in sd.values())),
                        (OBS,))
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(ravel_pytree(jparams)[0]))


def test_init_has_the_reference_ranges_and_spread():
    """Fan-in uniform hidden weights with zero biases, output weights in
    +-3e-3 and output biases in [0, 3e-3), per layer, as flax draws them:
    the same support and a standard deviation within 5% of flax's."""
    gen = torch.Generator().manual_seed(0)
    sd = DdpgMlpModel(ACT, OBS, generator=gen).state_dict()
    jsd = convert_ddpg_mlp(jax.device_get(JaxDdpg(action_dim=ACT).init(
        jax.random.PRNGKey(0), np.zeros((1, OBS), np.float32))))
    assert set(sd) == set(jsd)
    for k, v in sd.items():
        ref = jsd[k]
        assert v.shape == ref.shape, k
        lo, hi = float(ref.min()), float(ref.max())
        if k.endswith("_out.weight"):
            lo, hi = -3e-3, 3e-3
        elif k.endswith("_out.bias"):
            lo, hi = 0.0, 3e-3
        elif k.endswith(".bias"):
            assert not v.any() and not ref.any(), k
            continue
        else:
            lim = 1.0 / np.sqrt(v.shape[1])
            lo, hi = -lim, lim
            assert float(ref.abs().max()) <= lim * (1 + 1e-6), k
        assert lo <= float(v.min()) and float(v.max()) <= hi, k
        if v.numel() >= 200:
            assert float(v.std()) == pytest.approx(float(ref.std()),
                                                   rel=0.05), k


def _tree(ref):
    """A JAX params-shaped tree (whole or one net) as port tensors."""
    return convert_ddpg_mlp(jax.device_get(ref))


def _adam(opt_state):
    """optax's ``ScaleByAdamState`` inside a chain's state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _adam(s)
            if found is not None:
                return found
    return None


def _close(port: dict, ref: dict, what: str, tol=TOL):
    assert set(port) == set(ref), what
    for k in ref:
        np.testing.assert_allclose(port[k].numpy(), ref[k].numpy(),
                                   err_msg=f"{what} {k}", **tol)


def _ddpg_pair(coupled: bool, **kw):
    """The JAX and the port states and steps of row 16's DDPG on one set
    of weights."""
    over = dict(ddpg_coupled_update=coupled, **kw)
    jopt = jax_options(16, **over)
    jspec = JaxEnvSpec(state_shape=(OBS,), discrete=False, num_actions=0,
                       action_dim=ACT, norm_val=1.0)
    jmodel = jax_build_model(jopt, jspec)
    jparams = jax_init_params(jopt, jspec, jmodel, seed=3)
    jstate, jstep = jax_state_and_step(jopt, jspec, jmodel, jparams)
    opt = build_options(16, device="cpu", **over)
    model = build_model(opt, EnvSpec((OBS,), 0, 1.0, False, ACT))
    state, step = build_train_state_and_step(opt, model, _tree(jparams))
    return opt, jopt, jstate, jstep, state, step, model, jmodel


def _batch(seed: int, lead=(B,)):
    rng = np.random.default_rng(seed)
    cols = dict(
        state0=rng.normal(size=(*lead, OBS)).astype(np.float32),
        action=rng.uniform(-1, 1, (*lead, ACT)).astype(np.float32),
        reward=rng.normal(size=lead).astype(np.float32),
        gamma_n=np.full(lead, 0.99 ** 5, np.float32),
        state1=rng.normal(size=(*lead, OBS)).astype(np.float32),
        terminal1=(rng.random(lead) < 0.3).astype(np.float32),
        weight=rng.uniform(0.2, 1.0, lead).astype(np.float32),
        index=np.broadcast_to(np.arange(lead[-1], dtype=np.int32),
                              lead).copy())
    return (JaxBatch(**cols),
            Batch(**{k: torch.from_numpy(v.copy()) for k, v in cols.items()}))


def _compare_split(jstate, state, tol=TOL):
    for net in ("actor", "critic"):
        _close(state.params[net], _tree(jstate.params[net]),
               f"params {net}", tol)
        _close(state.target_params[net], _tree(jstate.target_params[net]),
               f"target {net}", tol)
        ja = _adam(jstate.opt_state[net])
        _close(state.opt_state[net].mu, _tree(ja.mu), f"mu {net}", tol)
        _close(state.opt_state[net].nu, _tree(ja.nu), f"nu {net}", tol)
        assert int(state.opt_state[net].count) == int(ja.count)
    assert int(state.step) == int(jstate.step)


@pytest.mark.parametrize("coupled", [False, True],
                         ids=["decoupled", "coupled"])
def test_steps_match_optax_over_five_updates(coupled):
    opt, _jopt, jstate, jstep, state, step, _m, _jm = _ddpg_pair(coupled)
    assert opt.agent_params.clip_grad == 40.0
    assert opt.agent_params.target_model_update == 1e-3
    jstep = jax.jit(jstep)
    for i in range(5):
        jb, b = _batch(i)
        jstate, jm, jtd = jstep(jstate, jb)
        state, m, td = step(state, b)
        np.testing.assert_allclose(td.numpy(), np.asarray(jtd), **TOL)
        for k in (*METRICS, SKIPPED_KEY):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    if coupled:
        _close(state.params, _tree(jstate.params), "params")
        _close(state.target_params, _tree(jstate.target_params), "target")
        ja = _adam(jstate.opt_state)
        _close(state.opt_state.mu, _tree(ja.mu), "mu")
        _close(state.opt_state.nu, _tree(ja.nu), "nu")
        assert int(state.opt_state.count) == int(ja.count) == 5
        assert int(state.step) == 5
    else:
        _compare_split(jstate, state)
    # what the learner publishes is the model's whole state dict
    assert set(published_params(opt, state)) == set(
        DdpgMlpModel(ACT, OBS).state_dict())


def test_ddpg_lr_decay_matches_optax():
    """``lr_decay``: both optimizers anneal to 0 over ``steps`` (10)."""
    _o, _j, jstate, jstep, state, step, _m, _jm = _ddpg_pair(
        False, lr_decay=True, steps=10)
    jstep = jax.jit(jstep)
    for i in range(5):
        jb, b = _batch(10 + i)
        jstate, _jm2, _jtd = jstep(jstate, jb)
        state, _m2, _td = step(state, b)
    _compare_split(jstate, state)


@pytest.mark.parametrize("knob", ["lr_decay", "weight_decay", "both"])
def test_dqn_optimizer_chain_matches_optax(knob):
    """Row 1's dqn step with ``weight_decay`` 0.1 and/or ``lr_decay`` over
    10 steps, 5 updates, against optax's ``chain(clip, add_decayed_weights,
    adam(linear_schedule))``."""
    over = dict(hidden_dim=32, lr=1e-2, steps=10, clip_grad=1.0,
                target_model_update=2)
    if knob in ("lr_decay", "both"):
        over["lr_decay"] = True
    if knob in ("weight_decay", "both"):
        over["weight_decay"] = 0.1
    jopt = jax_options(1, **over)
    jspec = JaxEnvSpec(state_shape=(8,), discrete=True, num_actions=2,
                       action_dim=0, norm_val=1.0)
    jmodel = jax_build_model(jopt, jspec)
    jparams = jax_init_params(jopt, jspec, jmodel, seed=1)
    jstate, jstep = jax_state_and_step(jopt, jspec, jmodel, jparams)
    jstep = jax.jit(jstep)
    opt = build_options(1, device="cpu", **over)
    model = build_model(opt, EnvSpec((8,), 2, 1.0))
    state, step = build_train_state_and_step(
        opt, model, convert_dqn_mlp(jax.device_get(jparams)))
    rng = np.random.default_rng(7)
    for _ in range(5):
        cols = dict(
            state0=rng.normal(size=(B, 8)).astype(np.float32),
            action=rng.integers(0, 2, B).astype(np.int32),
            reward=rng.normal(size=B).astype(np.float32),
            gamma_n=np.full(B, 0.99 ** 5, np.float32),
            state1=rng.normal(size=(B, 8)).astype(np.float32),
            terminal1=(rng.random(B) < 0.3).astype(np.float32),
            weight=np.ones(B, np.float32),
            index=np.arange(B, dtype=np.int32))
        jstate, _jm, _jtd = jstep(jstate, JaxBatch(**cols))
        state, _m, _td = step(state, Batch(**{
            k: torch.from_numpy(v) for k, v in cols.items()}))
    conv = lambda t: convert_dqn_mlp(jax.device_get(t))
    _close(state.params, conv(jstate.params), "params")
    _close(state.target_params, conv(jstate.target_params), "target")
    ja = _adam(jstate.opt_state)
    _close(state.opt_state.mu, conv(ja.mu), "mu")
    _close(state.opt_state.nu, conv(ja.nu), "nu")
    assert int(state.opt_state.count) == 5


def test_weight_decay_stays_off_ddpgs_optimizers():
    """As the reference's factory (:658-661): DDPG's Adams take no weight
    decay, so a ``weight_decay`` leaves its update as it was."""
    _o, _j, _js, _jst, s0, step0, _m, _jm = _ddpg_pair(False)
    _o, _j, _js, _jst, s1, step1, _m, _jm = _ddpg_pair(False,
                                                       weight_decay=0.5)
    _jb, b = _batch(3)
    a, _ma, _ta = step0(s0, b)
    c, _mc, _tc = step1(s1, b)
    for net in ("actor", "critic"):
        for k in a.params[net]:
            assert torch.equal(a.params[net][k], c.params[net][k])


@functools.lru_cache(maxsize=None)
def _group_pair():
    over = dict(megabatch=4)
    _o, jopt, jstate, _js, state, step, model, jmodel = _ddpg_pair(
        False, **over)
    jmega = jax.jit(jax_mega_step(jopt, jmodel))
    opt = build_options(16, device="cpu", **over)
    mega = build_megabatch_train_step(opt, model)
    return opt, jstate, jmega, state, step, mega, model


def test_group_of_four_matches_the_jax_group_step():
    _opt, jstate, jmega, state, _step, mega, _model = _group_pair()
    jb, b = _batch(21, lead=(4, B))
    jnew, jm, jtd, jok = jmega(jstate, jb)
    new, m, td, ok = mega(state, b)
    assert ok.tolist() == np.asarray(jok).tolist() == [1.0] * 4
    _compare_split(jnew, new, GROUP_TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jtd), **GROUP_TOL)
    for k in (*METRICS, SKIPPED_KEY):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                   atol=5e-5, err_msg=k)
    assert int(new.step) == 4


def test_group_of_one_is_the_sequential_step():
    opt, _jstate, _jmega, state, step, _mega, model = _group_pair()
    opt1 = build_options(16, device="cpu")
    mega1 = build_megabatch_train_step(opt1, model)
    _jb, b = _batch(22, lead=(1, B))
    g_state, g_m, g_td, ok = mega1(state, b)
    s_state, s_m, s_td = step(state, Batch(*(t[0] for t in b)))
    assert ok.tolist() == [1.0]
    tol = dict(rtol=1e-5, atol=1e-6)
    for net in ("actor", "critic"):
        _close(g_state.params[net], s_state.params[net], net, tol)
        _close(g_state.target_params[net], s_state.target_params[net],
               net, tol)
    np.testing.assert_allclose(g_td[0].numpy(), s_td.numpy(), **tol)
    for k in METRICS:
        np.testing.assert_allclose(float(g_m[k]), float(s_m[k]), err_msg=k,
                                   **tol)


def test_a_non_finite_actor_stage_keeps_its_critic_update():
    """Minibatch 1 of 4 gets NaN actions from the policy in the group's
    actor stage only (its critic stage reads the stored actions): the
    critic chain is the clean group's to the bit; the actor, the targets
    and the step skip that minibatch alone; its |TD| reads 0."""
    opt, _jstate, _jmega, state, _step, mega, model = _group_pair()
    actor_fn, critic_fn = ddpg_applies(model)

    def poisoned_actor(params, obs):
        a = actor_fn(params, obs)
        if obs.dim() == 3:  # the actor stage's stacked (M, B, ...) rows
            a = torch.cat([a[:1], a[1:2] * float("nan"), a[2:]])
        return a

    bad = build_ddpg_megabatch_step(
        poisoned_actor, critic_fn, *make_optimizers(opt),
        target_model_update=opt.agent_params.target_model_update)
    _jb, b = _batch(23, lead=(4, B))
    clean, _cm, clean_td, _cok = mega(state, b)
    new, m, td, ok = bad(state, b)
    assert ok.tolist() == [1.0, 0.0, 1.0, 1.0]
    assert float(m[SKIPPED_KEY]) == 1.0
    assert int(new.step) == 3
    for k, v in clean.params["critic"].items():
        assert torch.equal(new.params["critic"][k], v), k
    assert not td[1].any() and torch.equal(td[0], clean_td[0])
    for k, v in new.params["actor"].items():
        assert torch.isfinite(v).all() and not torch.equal(
            v, clean.params["actor"][k]), k
    for tree in (new.target_params["actor"], new.target_params["critic"]):
        assert all(torch.isfinite(v).all() for v in tree.values())


@pytest.mark.parametrize("huber", [False, True], ids=["mse", "huber"])
def test_value_loss_matches_the_reference(huber):
    """``_value_loss``: the squared error with no 1/2 factor, or optax's
    Huber loss at delta 1, weighted and averaged, and |TD| (reference
    ops/losses.py:85-95); TD errors on both sides of the Huber knee."""
    from pytorch_distributed_tpu.ops.losses import _value_loss as jax_loss
    from pytorch_distributed_tpu_torch.ops.losses import _value_loss

    rng = np.random.default_rng(int(huber))
    pred, tgt = rng.normal(0, 2, (2, 32)).astype(np.float32)
    w = rng.uniform(0.2, 1.0, 32).astype(np.float32)
    loss, td = _value_loss(*map(torch.from_numpy, (pred, tgt, w)), huber)
    jloss, jtd = jax_loss(pred, tgt, w, huber)
    assert (np.abs(pred - tgt) > 1).any() and (np.abs(pred - tgt) < 1).any()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jtd), rtol=1e-6)


def test_coupled_ddpg_has_no_group_step():
    opt = build_options(2, device="cpu", ddpg_coupled_update=True,
                        megabatch=4)
    model = build_model(opt, EnvSpec((3,), 0, 1.0, False, 1))
    assert build_megabatch_train_step(opt, model) is None
