"""Kernel B1 (the PER draw): the port's version on CPU tensors — its plain
blocked torch version — against the JAX package's Pallas
``hierarchical_sample`` run in interpret mode, on the same priorities and
the same uniforms (``jax.random.uniform(key, (B,))``, exactly what the
JAX function draws from its key).  The cases of tests/test_pallas_sampling.py
follow.  Indices must be equal and probabilities agree to rtol 1e-6 (the
same fp32 sums, taken in another order).  The zero-row remap is forced
where every implementation must take it: an empty vector (total 0), and
``u = 1``, whose target is the total and so lands past the last nonzero
row; a uniform below 1 cannot force it when the sums are exact, since
``u * total`` then stays below the last nonzero row's prefix."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pytorch_distributed_tpu.ops.pallas_sampling import (
    hierarchical_sample as jax_hierarchical_sample,
)
from pytorch_distributed_tpu_torch.ops import cuda_sampling
from pytorch_distributed_tpu_torch.ops.cuda_sampling import (
    hierarchical_sample, sample_plain,
)


def _priorities(n: int, zero_frac: float = 0.3, seed: int = 0):
    rng = np.random.default_rng(seed)
    return np.where(rng.random(n) < zero_frac, 0.0,
                    rng.random(n)).astype(np.float32)


def _both(prio: np.ndarray, key, batch: int):
    idx_j, p_j = jax_hierarchical_sample(jnp.asarray(prio), key, batch,
                                         interpret=True)
    u = np.array(jax.random.uniform(key, (batch,)))
    idx_t, p_t = hierarchical_sample(torch.from_numpy(prio),
                                     torch.from_numpy(u))
    return (np.asarray(idx_j), np.asarray(p_j), idx_t.numpy(), p_t.numpy())


def _jax_on_uniforms(monkeypatch, prio: np.ndarray, u: np.ndarray):
    """The JAX function on the uniforms ``u``: its own uniform draw is
    replaced by ``u``, and it runs unjitted so no cached trace keeps the
    real draw."""
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape: jnp.asarray(u))
    idx, p = jax_hierarchical_sample.__wrapped__(
        jnp.asarray(prio), jax.random.PRNGKey(0), len(u), interpret=True)
    return np.asarray(idx), np.asarray(p)


def _raw_inverse_cdf(prio: np.ndarray, u: np.ndarray) -> np.ndarray:
    """The flat inverse-CDF row of each draw before the remap, in float64."""
    cdf = np.cumsum(prio.astype(np.float64))
    return np.minimum(np.searchsorted(cdf, u * cdf[-1], side="right"),
                      len(prio) - 1)


@pytest.mark.parametrize("case", ["empty", "past_last_row"])
def test_forced_zero_row_remap_matches_jax(monkeypatch, case):
    n = 3000  # 3 superblocks, the last one ragged
    prio = np.zeros(n, np.float32)
    if case == "empty":
        key = jax.random.PRNGKey(11)
        u = np.array(jax.random.uniform(key, (32,)))
        idx_j, p_j = jax_hierarchical_sample(jnp.asarray(prio), key, 32,
                                             interpret=True)
        first_max = 0  # every row ties at 0
    else:
        # trailing zero rows from 1,500, and a tie at the maximum
        prio[:1500] = _priorities(1500, zero_frac=0.0, seed=5)
        prio[[700, 1499]] = 2.0
        first_max = 700
        u = np.concatenate([
            [1.0, np.nextafter(np.float32(1), np.float32(0)), 0.0],
            np.random.default_rng(6).random(29)]).astype(np.float32)
        idx_j, p_j = _jax_on_uniforms(monkeypatch, prio, u)
    forced = prio[_raw_inverse_cdf(prio, u)] == 0
    assert forced.any()  # the remap fired
    idx_t, p_t = sample_plain(torch.from_numpy(prio), torch.from_numpy(u))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-6)
    assert (idx_t.numpy()[forced] == first_max).all()
    assert (prio[idx_t.numpy()] > 0).all() or case == "empty"


@pytest.mark.parametrize("n", [1000, 4096, 131072])
def test_matches_jax_kernel(n):
    idx_j, p_j, idx_t, p_t = _both(_priorities(n), jax.random.PRNGKey(7), 64)
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_allclose(p_t, p_j, rtol=1e-6)


def test_never_draws_empty_rows():
    prio = np.zeros(8192, np.float32)
    prio[:3000] = _priorities(3000, zero_frac=0.0)
    idx_j, _, idx_t, _ = _both(prio, jax.random.PRNGKey(3), 256)
    assert (idx_t < 3000).all()
    np.testing.assert_array_equal(idx_t, idx_j)


def test_single_block_edge():
    prio = _priorities(100, zero_frac=0.0)
    idx_j, p_j, idx_t, p_t = _both(prio, jax.random.PRNGKey(1), 32)
    assert (idx_t < 100).all()
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_allclose(p_t, p_j, rtol=1e-6)


def test_distribution_proportional_to_priority():
    prio = np.zeros(2048, np.float32)
    hot = [5, 100, 1024, 2000]
    weights = [1.0, 2.0, 4.0, 8.0]
    prio[hot] = weights
    counts = np.zeros(2048)
    gen = torch.Generator().manual_seed(0)
    for _ in range(40):
        idx, _ = hierarchical_sample(torch.from_numpy(prio),
                                     torch.rand(128, generator=gen))
        np.add.at(counts, idx.numpy(), 1)
    frac = counts[hot] / counts.sum()
    np.testing.assert_allclose(frac, np.asarray(weights) / sum(weights),
                               atol=0.03)


def test_cpu_takes_plain_version_and_counts_no_launch():
    before = hierarchical_sample.launches
    p = torch.from_numpy(_priorities(5000))
    u = torch.rand(16, generator=torch.Generator().manual_seed(1))
    i1, p1 = hierarchical_sample(p, u)
    i2, p2 = sample_plain(p, u)
    assert torch.equal(i1, i2) and torch.equal(p1, p2)
    assert hierarchical_sample.launches == before


@pytest.mark.parametrize("bad", ["dtype", "rank", "device", "empty"])
def test_rejects_what_the_kernel_does_not_take(bad):
    p = torch.rand(64)
    u = torch.rand(4)
    if bad == "dtype":
        p = p.double()
    elif bad == "rank":
        p = p.view(8, 8)
    elif bad == "device":
        p = p.to("meta")
    else:
        u = u[:0]
    with pytest.raises(ValueError):
        cuda_sampling.hierarchical_sample(p, u)
