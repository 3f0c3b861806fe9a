"""Reference ``DqnCnnModel`` and ``DqnMlpModel`` params -> the port's
``state_dict``.

Takes the flax param tree of pytorch_distributed_tpu/models/dqn_cnn.py as
nested dicts of array-likes (numpy, or anything ``np.asarray`` reads) and
returns the port's ``DqnCnnModel`` state_dict as fp32 tensors.  Three
layout traps:

- conv kernels are HWIO in flax and OIHW in torch;
- a flax ``Dense`` kernel is (in, out), a torch ``Linear`` weight (out, in);
- flax flattens the last conv's NHWC activations in (h, w, c) order before
  ``Dense_0`` (reference dqn_cnn.py:64) where the port's NCHW flatten is
  (c, h, w), so ``Dense_0``'s input rows are permuted.

The MLP (``convert_dqn_mlp``) has only the second: its ``Dense_0`` to
``Dense_2`` are ``fc0`` to ``fc2`` and ``Dense_3`` is ``head``.

The transform is linear and per-leaf, so Adam moments (and gradients) of
the same tree go through it unchanged in meaning.  ``flax_leaves`` is its
inverse, for either model: the port's state_dict as the reference's
leaves, in the order ``ravel_pytree`` flattens them, which fixes the
layout of the published parameter vector (agents/param_store.py).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch.models.dqn_cnn import (
    CONV_LAYERS, torso_out_hw,
)
from pytorch_distributed_tpu_torch.models.dqn_mlp import HIDDEN_LAYERS

# the MLP's flax scopes in order, the head last
MLP_LAYERS = HIDDEN_LAYERS + ("head",)


def convert_dqn_cnn(params: Mapping, state_shape: Sequence[int]
                    ) -> Dict[str, torch.Tensor]:
    """``params`` is ``{"params": {...}}`` or the inner tree;
    ``state_shape`` is the (C, H, W) observation shape (it fixes the
    ``Dense_0`` permutation)."""
    p = params["params"] if "params" in params else params
    out: Dict[str, np.ndarray] = {}
    for i, (name, _cout, _k, _s) in enumerate(CONV_LAYERS):
        scope = p[f"Conv_{i}"]
        out[f"{name}.weight"] = np.asarray(scope["kernel"]).transpose(
            3, 2, 0, 1)
        out[f"{name}.bias"] = np.asarray(scope["bias"])
    oh, ow = torso_out_hw(*state_shape[1:])
    k0 = np.asarray(p["Dense_0"]["kernel"])           # rows (h, w, c)
    c = k0.shape[0] // (oh * ow)
    out["fc.weight"] = k0.reshape(oh, ow, c, -1).transpose(
        3, 2, 0, 1).reshape(k0.shape[1], -1)          # cols (c, h, w)
    out["fc.bias"] = np.asarray(p["Dense_0"]["bias"])
    out["head.weight"] = np.asarray(p["Dense_1"]["kernel"]).T
    out["head.bias"] = np.asarray(p["Dense_1"]["bias"])
    return {k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32)
            for k, v in out.items()}


def convert_dqn_mlp(params: Mapping) -> Dict[str, torch.Tensor]:
    """``params`` is ``{"params": {...}}`` or the inner tree of the
    reference's ``DqnMlpModel``."""
    p = params["params"] if "params" in params else params
    out: Dict[str, np.ndarray] = {}
    for i, name in enumerate(MLP_LAYERS):
        out[f"{name}.weight"] = np.asarray(p[f"Dense_{i}"]["kernel"]).T
        out[f"{name}.bias"] = np.asarray(p[f"Dense_{i}"]["bias"])
    return {k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32)
            for k, v in out.items()}


def flax_leaves(state_dict: Mapping[str, torch.Tensor],
                state_shape: Sequence[int]
                ) -> List[Tuple[str, torch.Tensor]]:
    """The port's ``DqnCnnModel`` or ``DqnMlpModel`` state_dict as the
    reference's flax leaves (``Conv_0/bias``, ``Conv_0/kernel``, ...,
    ``Dense_1/kernel``: keys sorted at every level, as ``ravel_pytree``
    orders a flax tree), each a view of the torch tensor in the flax
    layout.  No data is copied."""
    if "conv0.weight" not in state_dict:
        out = []
        for i, name in enumerate(MLP_LAYERS):
            out += [(f"Dense_{i}/bias", state_dict[f"{name}.bias"]),
                    (f"Dense_{i}/kernel", state_dict[f"{name}.weight"].t())]
        return out
    oh, ow = torso_out_hw(*state_shape[1:])
    fc = state_dict["fc.weight"]                      # cols (c, h, w)
    c = fc.shape[1] // (oh * ow)
    kernels = {f"Conv_{i}": state_dict[f"{name}.weight"].permute(2, 3, 1, 0)
               for i, (name, _cout, _k, _s) in enumerate(CONV_LAYERS)}
    kernels["Dense_0"] = fc.reshape(-1, c, oh, ow).permute(
        2, 3, 1, 0)                                   # rows (h, w, c)
    kernels["Dense_1"] = state_dict["head.weight"].t()
    biases = {f"Conv_{i}": state_dict[f"{name}.bias"]
              for i, (name, _cout, _k, _s) in enumerate(CONV_LAYERS)}
    biases.update(Dense_0=state_dict["fc.bias"],
                  Dense_1=state_dict["head.bias"])
    out = []
    for scope in sorted(kernels):
        out += [(f"{scope}/bias", biases[scope]),
                (f"{scope}/kernel", kernels[scope])]
    return out
