"""The port's mixture of experts (models/moe.py) against the JAX package's
(pytorch_distributed_tpu/models/moe.py) on the same numpy inputs:

- ``top_k_dispatch`` against ``_top_k_dispatch`` EXACTLY (dispatch,
  combine and the rank-0 mask, to the bit) given the same probabilities,
  at k = 1 and 2 and at capacities that drop overflowing tokens and that
  do not; ties cannot arise (the probabilities are a softmax of
  continuous draws);
- ``moe_ffn`` against ``MoeFfn`` on converted weights: the output within
  rtol 1e-5, atol 1e-5 and the aux loss within rtol 1e-6, with every
  token's top-2 router margins above 1e-4 in logits (checked, about 100
  times fp32's rounding), so routing cannot flip between the packages;
- the model's ``window_q_with_aux`` (q and the blocks' mean aux) against
  the reference's ``window_q_with_aux``, the same tolerances;
- the capacity: 26 slots at the reference's full width (window 81, 8
  experts, top-2, factor 1.25), the reference's formula at other sizes;
- the expert kernels' init at full width: LeCun normal with E in the
  fan-in, std 1/sqrt(D E) (0.03125 at D 128, E 8) for ``w1`` and
  1/sqrt(4 D E) for ``w2``, within 3% (flax's own init alike)."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pytorch_distributed_tpu.models import moe as jmoe
from pytorch_distributed_tpu_torch.convert import convert_dtqn
from pytorch_distributed_tpu_torch.models import moe as moe_mod
from pytorch_distributed_tpu_torch.models.moe import (
    DtqnMoeModel, moe_capacity, moe_ffn, top_k_dispatch,
)

D, E = 16, 4
TOL = dict(rtol=1e-5, atol=1e-5)
MIN_MARGIN = 1e-4


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _least_margin(probs: np.ndarray, k: int) -> float:
    s = np.sort(np.log(np.asarray(probs, np.float64)), axis=-1)[..., ::-1]
    return float(min((s[..., k - 1] - s[..., k]).min(),
                     (s[..., 0] - s[..., 1]).min()))


@pytest.mark.parametrize("top_k,capacity", [(2, 3), (2, 8), (1, 2), (1, 9),
                                            (2, 1)])
def test_top_k_dispatch_is_exact(top_k, capacity):
    rng = np.random.default_rng(top_k * 10 + capacity)
    B, T = 3, 9
    logits = 2.0 * rng.normal(size=(B, T, E)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(logits, axis=-1))
    want = jmoe._top_k_dispatch(jnp.asarray(probs), top_k, capacity)
    got = top_k_dispatch(_t(probs), top_k, capacity)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    kept = float(got[0].sum())
    assert kept <= B * T * top_k
    if capacity * E < T * top_k:  # fewer slots a row than choices
        assert kept < B * T * top_k  # some choices were dropped
    # a slot holds at most one token, and no slot past the capacity
    assert float(got[0].sum(1).max()) <= 1.0


def test_dispatch_drops_overflow_like_jax():
    """Every token picks expert 0 first: only the first ``capacity`` of a
    row get a rank-0 slot there, in time order."""
    B, T, C = 2, 7, 3
    logits = np.zeros((B, T, E), np.float32)
    logits[..., 0] = 5.0
    logits[..., 1] = np.linspace(1.0, 2.0, T)[None, :]  # no ties
    probs = np.asarray(jax.nn.softmax(logits, axis=-1))
    want = jmoe._top_k_dispatch(jnp.asarray(probs), 2, C)
    got = top_k_dispatch(_t(probs), 2, C)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    on0 = got[0][..., 0, :].sum(-1)  # (B, T): took a slot of expert 0
    np.testing.assert_array_equal(on0.numpy(),
                                  np.tile([1.0] * C + [0.0] * (T - C),
                                          (B, 1)))


def _ffn_pair(seed: int):
    ffn = jmoe.MoeFfn(D, num_experts=E, top_k=2, capacity_factor=1.0,
                      capacity_tokens=9)
    x = np.random.default_rng(seed).normal(size=(3, 9, D)).astype(np.float32)
    jp = ffn.init(jax.random.PRNGKey(seed), x)["params"]
    rng = np.random.default_rng(seed + 1)
    jp = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.3 * rng.normal(size=v.shape).astype(
            np.float32), jp)
    p = {"moe.router.weight": _t(np.asarray(jp["router"]["kernel"]).T),
         "moe.router.bias": _t(jp["router"]["bias"])}
    p.update({f"moe.{k}": _t(jp[k]) for k in ("w1", "b1", "w2", "b2")})
    return ffn, jp, p, x


def test_moe_ffn_matches_jax():
    ffn, jp, p, x = _ffn_pair(0)
    y_j, aux_j = ffn.apply({"params": jp}, x, mutable=[
        jmoe.AUX_COLLECTION])[0]
    cap = moe_capacity(1.0, 2, 9, E)
    y_t, aux_t = moe_ffn(p, "moe", _t(x), 2, cap)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)
    logits = x @ np.asarray(jp["router"]["kernel"]) + np.asarray(
        jp["router"]["bias"])
    assert _least_margin(jax.nn.softmax(logits), 2) > MIN_MARGIN
    assert float(np.abs(np.asarray(y_j)).max()) > 0.1


def test_window_q_with_aux_matches_jax(monkeypatch):
    jm = jmoe.DtqnMoeModel(action_space=3, state_shape=(8,), window=9,
                           dim=D, heads=4, depth=2, num_experts=E,
                           top_k=2, capacity_factor=1.0)
    jp = {"params": jm.init(jax.random.PRNGKey(1),
                            jnp.zeros((1, 8)))["params"]}
    rng = np.random.default_rng(2)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, v: np.asarray(v) + (0.8 if any(
            getattr(k, "key", None) == "router" for k in path) else 0.2)
        * rng.normal(size=v.shape).astype(np.float32), jp)
    tm = DtqnMoeModel(3, (8,), 9, D, 4, 2, num_experts=E, top_k=2,
                      capacity_factor=1.0, init_weights=False)
    p = convert_dtqn(jp)
    tm.load_state_dict(p)
    least = []
    inner = moe_mod.top_k_dispatch

    def spy(probs, k, capacity):
        least.append(_least_margin(probs.detach().numpy(), k))
        return inner(probs, k, capacity)

    monkeypatch.setattr(moe_mod, "top_k_dispatch", spy)
    obs = rng.normal(size=(4, 9, 8)).astype(np.float32)
    q_j, aux_j = jmoe.window_q_with_aux(jm)(jp, obs)
    q_t, aux_t = tm.window_q_with_aux(p, _t(obs))
    np.testing.assert_allclose(q_t.detach().numpy(), np.asarray(q_j), **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)
    assert len(least) == 2 and min(least) > MIN_MARGIN


@pytest.mark.parametrize("factor,k,tokens,experts", [
    (1.25, 2, 81, 8), (1.0, 2, 9, 4), (1.25, 1, 17, 8), (2.0, 2, 3, 16),
    (0.01, 1, 5, 8)])
def test_capacity_matches_the_reference(factor, k, tokens, experts):
    want = max(int(-(-factor * k * tokens // experts)), 1)  # moe.py:115
    assert moe_capacity(factor, k, tokens, experts) == want
    if (factor, k, tokens, experts) == (1.25, 2, 81, 8):
        assert want == 26 == DtqnMoeModel(
            2, (8,), window=81, init_weights=False).capacity


def test_expert_init_is_lecun_over_d_times_e():
    tm = DtqnMoeModel(2, (8,), window=81, dim=128, heads=4, depth=2,
                      num_experts=8, generator=torch.Generator().manual_seed(3))
    jm = jmoe.DtqnMoeModel(action_space=2, state_shape=(8,), window=81)
    jp = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 8)))["params"]
    for i in range(2):
        blk = tm.blocks[i].moe
        jblk = jp[f"_MoeBlock_{i}"]["moe"]
        for name, fan in (("w1", 128 * 8), ("w2", 512 * 8)):
            want = 1.0 / math.sqrt(fan)
            got = float(getattr(blk, name).detach().double().std())
            flax = float(np.asarray(jblk[name], np.float64).std())
            assert abs(got / want - 1.0) < 0.03, (name, got, want)
            assert abs(flax / want - 1.0) < 0.03, (name, flax, want)
        assert abs(float(blk.w1.double().std()) - 0.03125) < 0.001
        assert not blk.b1.any() and not blk.b2.any()
        assert not blk.router.bias.any()
