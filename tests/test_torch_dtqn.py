"""The port's transformer Q-networks (models/dtqn.py, models/moe.py,
models/dtqn_pipeline.py) and its plain causal attention
(ops/ring_attention.py) against the JAX package's, on the same weights
(carried across by ``convert.convert_dtqn``) and the same numpy inputs, at
a small size (dim 32, 4 heads, depth 2, window 9, chain obs of 8):

- ``full_attention`` causal, with a key pad mask, and both, on square and
  on rectangular (tq < tk) scores: rtol 1e-5, atol 1e-6;
- each family's ``window_q`` against flax's (rtol 1e-5, atol 1e-5; the
  weights are flax's init plus noise, so the zero-init Q head reads
  something);
- each family's acting path, the packed act with per-row resets, over 14
  ticks of 3 rows (the window of 8 partly filled, then full and rolling,
  two rows reset at ticks 5 and 11): greedy actions equal, the (window,
  filled) carry to the bit, Q within rtol 1e-5 and atol 1e-5.  The MoE's
  inputs keep every token's top-2 router margins above 1e-4 in logits
  (about 100 times fp32's rounding), checked, so routing cannot flip
  between the packages;
- ``block_forward`` with a pad mask and ``scan_blocks`` on raw layer
  parameters (rtol 1e-5, atol 1e-5);
- the init statistics at the reference's full width against flax's own
  init (each kernel's spread within 6% of flax's and of its LeCun
  target, zero biases and Q head, unit LayerNorm scales, ``pos_embed``
  at 0.02), per layer for the stacked kernels;
- the published vector of every family in the reference's
  ``ravel_pytree`` layout, exactly, and back."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.flatten_util import ravel_pytree

from pytorch_distributed_tpu.models import policies as jpol
from pytorch_distributed_tpu.models.dtqn import DtqnMlpModel as JaxMlp
from pytorch_distributed_tpu.models.dtqn_pipeline import (
    DtqnPipelineModel as JaxPipe, block_forward as jax_block_forward,
    scan_blocks as jax_scan_blocks,
)
from pytorch_distributed_tpu.models.moe import DtqnMoeModel as JaxMoe
from pytorch_distributed_tpu.ops.ring_attention import (
    full_attention as jax_full_attention,
)
from pytorch_distributed_tpu_torch.agents.param_store import (
    flatten_into, make_flattener, num_params,
)
from pytorch_distributed_tpu_torch.convert import convert_dtqn
from pytorch_distributed_tpu_torch.models import moe as moe_mod
from pytorch_distributed_tpu_torch.models.dtqn import DtqnMlpModel
from pytorch_distributed_tpu_torch.models.dtqn_pipeline import (
    DtqnPipelineModel, block_forward, scan_blocks,
)
from pytorch_distributed_tpu_torch.models.moe import DtqnMoeModel
from pytorch_distributed_tpu_torch.models.policies import (
    recurrent_packed_act,
)
from pytorch_distributed_tpu_torch.ops.ring_attention import full_attention

OBS, A, DIM, HEADS, DEPTH, WINDOW = 8, 3, 32, 4, 2, 9
F32 = dict(rtol=1e-5, atol=1e-5)
FAMILIES = {"mlp": (JaxMlp, DtqnMlpModel), "moe": (JaxMoe, DtqnMoeModel),
            "pipe": (JaxPipe, DtqnPipelineModel)}
MOE_KW = dict(num_experts=4, top_k=2, capacity_factor=1.0)
# the MoE's inputs: top-2 router margins, in logits, at least this
# (checked), about 100 times fp32's rounding of a logit of a few units
MIN_MARGIN = 1e-4


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _pair(family: str, seed: int = 0, noise: float = 0.2, dim: int = DIM,
          window: int = WINDOW):
    """(jax model, its params with noise on every leaf, port model, the
    converted params)."""
    jcls, tcls = FAMILIES[family]
    kw = MOE_KW if family == "moe" else {}
    jm = jcls(action_space=A, state_shape=(OBS,), window=window, dim=dim,
              heads=HEADS, depth=DEPTH, **kw)
    jp = {"params": jm.init(jax.random.PRNGKey(seed),
                            jnp.zeros((1, OBS)))["params"]}
    rng = np.random.default_rng(seed + 100)

    def perturb(path, x):
        x = np.asarray(x)
        scale = noise
        if any(getattr(k, "key", None) == "router" for k in path):
            scale = 4.0 * noise  # well-separated routing choices
        return x + scale * rng.normal(size=x.shape).astype(np.float32)

    if noise:
        jp = jax.tree_util.tree_map_with_path(perturb, jp)
    tm = tcls(A, (OBS,), window, dim, HEADS, DEPTH, init_weights=False,
              **kw)
    p = convert_dtqn(jp)
    tm.load_state_dict(p)
    return jm, jp, tm, p


class _Margins:
    """Wraps the port's ``top_k_dispatch`` and records the smallest gap,
    in logits, between a token's k-th and (k+1)-th router choice, and
    between its first two."""

    def __init__(self, monkeypatch):
        self.least = float("inf")
        inner = moe_mod.top_k_dispatch

        def spy(probs, top_k, capacity):
            s = torch.sort(probs.detach().double(), dim=-1,
                           descending=True).values.clamp(min=1e-300).log()
            gaps = [s[..., top_k - 1] - s[..., top_k], s[..., 0] - s[..., 1]]
            self.least = min(self.least, *(float(g.min()) for g in gaps))
            return inner(probs, top_k, capacity)

        monkeypatch.setattr(moe_mod, "top_k_dispatch", spy)


@pytest.mark.parametrize("causal,pad,tq", [(True, False, 6), (False, True, 6),
                                           (True, True, 6), (True, False, 4),
                                           (True, True, 4)])
def test_full_attention_matches_jax(causal, pad, tq):
    rng = np.random.default_rng(1)
    B, H, tk, D = 3, 2, 6, 5
    q = rng.normal(size=(B, H, tq, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, H, tk, D)).astype(np.float32)
            for _ in "kv")
    mask = None
    if pad:  # row 2 has a single valid key
        mask = np.arange(tk)[None, :] < np.array([6, 3, 1])[:, None]
    want = jax_full_attention(q, k, v, causal=causal, key_pad_mask=mask)
    got = full_attention(_t(q), _t(k), _t(v), causal=causal,
                         key_pad_mask=None if mask is None else _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_window_q_matches_flax(family, monkeypatch):
    margins = _Margins(monkeypatch)
    jm, jp, tm, p = _pair(family)
    obs = np.random.default_rng(2).normal(
        size=(4, WINDOW, OBS)).astype(np.float32)
    want = jm.apply(jp, obs, method=jm.window_q)
    got = tm.window_q(p, _t(obs))
    assert float(np.abs(np.asarray(want)).max()) > 0.1
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)
    if family == "moe":
        assert margins.least > MIN_MARGIN


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_acting_path_with_resets_matches_flax(family, monkeypatch):
    margins = _Margins(monkeypatch)
    jm, jp, tm, p = _pair(family, seed=3)
    rng = np.random.default_rng(4)
    B = 3
    jact = jpol.build_recurrent_packed_act(jm.apply, jm.zero_carry(1))
    jcarry = jm.zero_carry(B)
    carry = tm.zero_carry(B)
    zeros, ones = torch.zeros(B), torch.ones(B)
    saw = set()
    for tick in range(14):
        obs = rng.normal(size=(B, OBS)).astype(np.float32)
        reset = np.zeros(B, bool)
        if tick in (5, 11):
            reset[[0, 2] if tick == 5 else [1]] = True
        # greedy (eps 0) on both sides, so no draw is compared
        a_j, jcarry = jact(jp, obs, jcarry, reset, jax.random.PRNGKey(tick),
                           tick, jnp.zeros(B, jnp.float32))
        a_t, carry = recurrent_packed_act(
            tm.step, p, _t(obs), carry, _t(reset), zeros, ones,
            torch.zeros(B, dtype=torch.int64))
        np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
        for want, got in zip(jcarry, carry):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        saw.update(int(f) for f in carry[1])
        # and Q itself from the carry before this tick's reset-free act
        q_j, _ = jm.apply(jp, obs, jcarry)
        q_t, _ = tm.step(p, _t(obs), carry)
        np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), **F32)
    # partly filled windows, full ones, and rows restarted by a reset
    assert {1, 3, WINDOW - 1} <= saw
    if family == "moe":
        assert margins.least > MIN_MARGIN


def _layer_params(rng, D: int, depth: int = 0):
    """One layer's raw parameters in flax's layout ((in, out) kernels), or
    ``depth`` stacked layers."""
    lead = (depth,) if depth else ()
    shapes = {"ln1_s": (D,), "ln1_b": (D,), "qkv_k": (D, 3 * D),
              "qkv_b": (3 * D,), "proj_k": (D, D), "proj_b": (D,),
              "ln2_s": (D,), "ln2_b": (D,), "ffn1_k": (D, 4 * D),
              "ffn1_b": (4 * D,), "ffn2_k": (4 * D, D), "ffn2_b": (D,)}
    out = {}
    for k, s in shapes.items():
        scale = 1.0 / np.sqrt(s[0]) if k.endswith("_k") else 0.3
        base = 1.0 if k.endswith("_s") else 0.0
        out[k] = (base + scale * rng.normal(size=lead + s)).astype(
            np.float32)
    return out


def _to_torch(layer: dict) -> dict:
    return {k: _t(np.swapaxes(v, -1, -2) if k.endswith("_k") else v)
            for k, v in layer.items()}


def test_block_forward_and_scan_blocks_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 7, DIM)).astype(np.float32)
    mask = np.arange(7)[None, :] < np.array([7, 4, 1])[:, None]
    layer = _layer_params(rng, DIM)
    want = jax_block_forward(layer, x, heads=HEADS, key_pad_mask=mask)
    got = block_forward(_to_torch(layer), _t(x), heads=HEADS,
                        key_pad_mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    stacked = _layer_params(rng, DIM, depth=3)
    want = jax_scan_blocks(stacked, x, heads=HEADS)
    got = scan_blocks(_to_torch(stacked), _t(x), heads=HEADS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _spread(x) -> float:
    return float(np.asarray(x, np.float64).std())


@pytest.mark.parametrize("family", ["mlp", "pipe"])
def test_init_statistics_match_flax(family):
    """At the reference's full width (dim 128, window 81)."""
    jcls, tcls = FAMILIES[family]
    jm = jcls(action_space=A, state_shape=(OBS,), window=81, dim=128,
              heads=HEADS, depth=DEPTH)
    jp = convert_dtqn(jm.init(jax.random.PRNGKey(7), jnp.zeros((1, OBS))))
    tm = tcls(A, (OBS,), 81, 128, HEADS, DEPTH,
              generator=torch.Generator().manual_seed(7))
    sd = tm.state_dict()
    assert sd.keys() == jp.keys()
    for k, v in sd.items():
        want = jp[k].numpy()
        if k.startswith("head.") or k.endswith("bias") or k.endswith("_b"):
            assert not v.any() and not want.any(), k  # zero, as flax's
        elif k.endswith(("ln1_s", "ln2_s")) or (
                "ln" in k and k.endswith(".weight")):
            assert torch.equal(v, torch.ones_like(v)), k
        elif k == "pos_embed":
            assert abs(_spread(v) / 0.02 - 1.0) < 0.06
            assert abs(_spread(want) / 0.02 - 1.0) < 0.06
        else:  # a kernel: LeCun normal over its (layer's) fan-in
            lecun = 1.0 / np.sqrt(v.shape[-1])
            assert abs(_spread(v) / lecun - 1.0) < 0.06, k
            assert abs(_spread(v) / _spread(want) - 1.0) < 0.06, k
            if family == "pipe" and k.startswith("blocks."):  # by layer
                for layer in v:
                    assert abs(_spread(layer) / lecun - 1.0) < 0.08, k


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_published_vector_is_ravel_pytree(family):
    _jm, jp, tm, p = _pair(family, seed=8)
    flat = flatten_into(p, torch.empty(num_params(p)), (OBS,)).numpy()
    np.testing.assert_array_equal(flat, np.asarray(ravel_pytree(jp)[0]))
    _flat0, unflatten = make_flattener(tm.state_dict(), (OBS,))
    back = unflatten(flat)
    for k, v in p.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy())
