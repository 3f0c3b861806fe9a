"""The published parameter vector, port against reference.

``make_flattener`` lays the port's ``dqn-cnn`` state_dict out as the
reference's ``ravel_pytree`` lays out the flax tree
(pytorch_distributed_tpu/agents/param_store.py:209): on the same weights
(the flax params converted by ``convert.py``) the two vectors must be
equal exactly, element for element.  Then the vector goes through the
shared store and back into tensors, exactly, and the reference's unravel
reads the port's vector as its own tree.
"""

import numpy as np
import pytest

import jax
from jax.flatten_util import ravel_pytree

from pytorch_distributed_tpu.config import build_options as jax_options
from pytorch_distributed_tpu.factory import (
    EnvSpec as JaxEnvSpec, build_model as jax_build_model,
    init_params as jax_init_params,
)
from pytorch_distributed_tpu_torch.agents.param_store import (
    ParamStore, flatten_into, make_flattener, num_params,
)
from pytorch_distributed_tpu_torch.convert import convert_dqn_cnn

import torch

ACTIONS = 6


def _params(frame):
    opt = jax_options(12, compute_dtype="float32")
    spec = JaxEnvSpec(state_shape=frame, discrete=True, num_actions=ACTIONS,
                      action_dim=0, norm_val=255.0)
    jparams = jax.device_get(jax_init_params(
        opt, spec, jax_build_model(opt, spec), seed=7))
    # non-zero biases, so a misplaced bias would show
    jparams = jax.tree_util.tree_map(
        lambda x: x + np.float32(0.01) * np.arange(x.size, dtype=np.float32
                                                   ).reshape(x.shape) / x.size,
        jparams)
    return jparams, convert_dqn_cnn(jparams, frame)


@pytest.mark.parametrize("frame", [(4, 44, 44), (4, 84, 84)],
                         ids=["44x44", "84x84"])
def test_flat_vector_is_the_references_ravel(frame):
    jparams, params = _params(frame)
    ref_flat, unravel = ravel_pytree(jparams)
    ref_flat = np.asarray(ref_flat)
    flat0, _unflatten = make_flattener(params, frame)
    assert flat0.dtype == np.float32 and flat0.shape == ref_flat.shape
    assert np.array_equal(flat0, ref_flat)
    # the learner's inline path writes the same vector
    out = flatten_into(params, torch.empty(num_params(params)), frame)
    assert np.array_equal(out.numpy(), ref_flat)
    # the reference reads the port's vector as its own tree
    back = unravel(flat0)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jparams)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_store_round_trip_and_unflatten():
    frame = (4, 44, 44)
    _jparams, params = _params(frame)
    flat0, unflatten = make_flattener(params, frame)
    store = ParamStore(flat0.size)
    assert store.fetch(0) is None
    assert store.publish(flat0) == 1
    flat, version = store.fetch(0)
    assert version == 1 and store.fetch(1) is None
    assert np.array_equal(flat, flat0)
    back = unflatten(flat)
    assert back.keys() == params.keys()
    for k, v in params.items():
        assert back[k].dtype == torch.float32 and back[k].device.type == "cpu"
        assert torch.equal(back[k], v), k
    with pytest.raises(ValueError):
        store.publish(flat0[:-1])
