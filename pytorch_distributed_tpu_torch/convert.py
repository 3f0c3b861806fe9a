"""Reference ``DqnCnnModel``, ``DqnCnnWideModel``, ``DqnMlpModel``,
``DdpgMlpModel``, ``DrqnMlpModel``, ``DrqnCnnModel`` and DTQN
(``DtqnMlpModel``, ``DtqnMoeModel``, ``DtqnPipelineModel``) params -> the
port's ``state_dict``.

Takes the flax param tree of pytorch_distributed_tpu/models/dqn_cnn.py as
nested dicts of array-likes (numpy, or anything ``np.asarray`` reads) and
returns the port's ``DqnCnnModel`` state_dict as fp32 tensors.  Three
layout traps:

- conv kernels are HWIO in flax and OIHW in torch;
- a flax ``Dense`` kernel is (in, out), a torch ``Linear`` weight (out, in);
- flax flattens the last conv's NHWC activations in (h, w, c) order before
  ``Dense_0`` (reference dqn_cnn.py:64) where the port's NCHW flatten is
  (c, h, w), so ``Dense_0``'s input rows are permuted.

The MLPs (``convert_dqn_mlp``, ``convert_ddpg_mlp``) have only the
second.  The DQN MLP: its ``Dense_0`` to
``Dense_2`` are ``fc0`` to ``fc2`` and ``Dense_3`` is ``head``.  The wide
torso (``convert_dqn_cnn_wide``, models/dqn_cnn_wide.py) has all three:
its section convolutions ``Conv_i`` are ``conv{i}``, the residual blocks
``_ResBlock_k/Conv_j`` are ``res{k}.conv{j}``, and ``Dense_0`` (rows (h,
w, c) of the 11 x 11 x 256 activations at 84 x 84) and ``Dense_1`` are
``fc`` and ``head``.

The recurrent models (``convert_drqn``, models/drqn.py) keep flax's
``OptimizedLSTMCell_0`` in one scope of eight: ``ii``, ``if``, ``ig``,
``io`` (input kernels, (in, H), no bias) and ``hi``, ``hf``, ``hg``,
``ho`` (recurrent kernels, (H, H), with the bias).  They go into the
port's stacked ``lstm.weight_ih`` (4H, in), ``lstm.weight_hh`` (4H, H)
and ``lstm.bias`` (4H,) in gate order (i, f, g, o), each kernel
transposed.  Their ``Dense_0`` is ``fc`` (for the CNN with the (h, w, c)
rows permuted as above) and ``Dense_1`` is ``head``.

The transformer families (``convert_dtqn``, models/dtqn.py, moe.py,
dtqn_pipeline.py) map scope to module by ``_dtqn_layout``: the dense and
MoE families' ``Dense_0`` is ``embed``, ``Dense_1`` ``head``,
``LayerNorm_0`` ``head_ln``, and block i's (``_Block_i`` or
``_MoeBlock_i``) ``LayerNorm_0``, ``Dense_0``, ``Dense_1``,
``LayerNorm_1`` are ``blocks.i.ln1``, ``qkv``, ``proj``, ``ln2``, then
the dense block's ``Dense_2``, ``Dense_3`` ``ffn1``, ``ffn2`` and the MoE
block's ``moe/router`` and ``moe/{w1,b1,w2,b2}`` (the expert tensors as
they are, E leading); the stacked family's ``embed_in``, ``head_ln``,
``head_q`` and ``blocks/*`` (each ``*_k`` transposed layer by layer, the
depth axis leading).  LayerNorm's ``scale`` is torch's ``weight``.

The transform is linear and per-leaf, so Adam moments (and gradients) of
the same tree go through it unchanged in meaning.  ``flax_leaves`` is its
inverse, for either model: the port's state_dict as the reference's
leaves, in the order ``ravel_pytree`` flattens them, which fixes the
layout of the published parameter vector (agents/param_store.py).
Flax sorts its keys as strings at every level: ``Dense_0`` < ``Dense_1``
< ``LayerNorm_0`` < ``_Block_0`` < ``pos_embed``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch.models.dqn_cnn import (
    CONV_LAYERS, torso_out_hw,
)
from pytorch_distributed_tpu_torch.models import dqn_cnn_wide as wide
from pytorch_distributed_tpu_torch.models.ddpg_mlp import (
    ACTOR_LAYERS, CRITIC_LAYERS,
)
from pytorch_distributed_tpu_torch.models.dqn_mlp import HIDDEN_LAYERS
from pytorch_distributed_tpu_torch.models.drqn import GATES
from pytorch_distributed_tpu_torch.models.dtqn_pipeline import stacked_shapes

# the MLP's flax scopes in order, the head last
MLP_LAYERS = HIDDEN_LAYERS + ("head",)
# the DDPG model's scopes, in ``ravel_pytree``'s (sorted) order
DDPG_LAYERS = ACTOR_LAYERS + CRITIC_LAYERS


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


def _dense0_rows_to_cols(k0: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """A flax ``Dense_0`` kernel, rows (h, w, c), as a torch weight whose
    columns are (c, h, w)."""
    c = k0.shape[0] // (oh * ow)
    return k0.reshape(oh, ow, c, -1).transpose(3, 2, 0, 1).reshape(
        k0.shape[1], -1)


def _wide_scopes(num_blocks: int):
    """(flax scope path, torch module name) of every wide-torso layer."""
    out = [((f"Conv_{i}",), f"conv{i}") for i in range(wide.SECTIONS)]
    for k in range(num_blocks):
        out += [((f"_ResBlock_{k}", f"Conv_{j}"), f"res{k}.conv{j}")
                for j in range(2)]
    return out


def convert_dqn_cnn_wide(params: Mapping, state_shape: Sequence[int]
                         ) -> Dict[str, torch.Tensor]:
    """``params`` is ``{"params": {...}}`` or the inner tree of the
    reference's ``DqnCnnWideModel``; ``state_shape`` the (C, H, W)
    observation shape."""
    p = params["params"] if "params" in params else params
    out: Dict[str, np.ndarray] = {}
    for path, name in _wide_scopes(wide.SECTIONS * wide.BLOCKS_PER_SECTION):
        scope = p
        for key in path:
            scope = scope[key]
        out[f"{name}.weight"] = np.asarray(scope["kernel"]).transpose(
            3, 2, 0, 1)
        out[f"{name}.bias"] = np.asarray(scope["bias"])
    oh, ow = wide.torso_out_hw(*state_shape[1:])
    out["fc.weight"] = _dense0_rows_to_cols(np.asarray(p["Dense_0"]["kernel"]),
                                            oh, ow)
    out["fc.bias"] = np.asarray(p["Dense_0"]["bias"])
    out["head.weight"] = np.asarray(p["Dense_1"]["kernel"]).T
    out["head.bias"] = np.asarray(p["Dense_1"]["bias"])
    return {k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32)
            for k, v in out.items()}


def _flax_leaves_wide(state_dict, state_shape) -> List[Tuple[str, torch.Tensor]]:
    """The wide torso's leaves in ``ravel_pytree`` order (scopes sorted:
    ``Conv_*``, ``Dense_*``, then ``_ResBlock_*``)."""
    oh, ow = wide.torso_out_hw(*state_shape[1:])
    leaves = {}
    blocks = sum(1 for k in state_dict if k.endswith(".conv0.weight"))
    for path, name in _wide_scopes(blocks):
        scope = "/".join(path)
        leaves[f"{scope}/bias"] = state_dict[f"{name}.bias"]
        leaves[f"{scope}/kernel"] = state_dict[f"{name}.weight"].permute(
            2, 3, 1, 0)
    fc = state_dict["fc.weight"]                      # cols (c, h, w)
    c = fc.shape[1] // (oh * ow)
    leaves["Dense_0/bias"] = state_dict["fc.bias"]
    leaves["Dense_0/kernel"] = fc.reshape(-1, c, oh, ow).permute(2, 3, 1, 0)
    leaves["Dense_1/bias"] = state_dict["head.bias"]
    leaves["Dense_1/kernel"] = state_dict["head.weight"].t()
    return sorted(leaves.items(), key=lambda kv: kv[0].split("/"))


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


def convert_ddpg_mlp(params: Mapping) -> Dict[str, torch.Tensor]:
    """``params`` is ``{"params": {...}}`` or the inner tree of the
    reference's ``DdpgMlpModel``: each ``Dense`` scope (``actor_l1`` ...
    ``critic_out``) is the module of the same name, its kernel transposed.
    ``critic_l2``'s kernel has 400 + d input rows, the action's last, as
    the port's concatenation orders them.  A tree of one net (the
    decoupled state's ``{"actor": ...}`` half, or its Adam moments)
    converts to that net's keys."""
    p = params["params"] if "params" in params else params
    out: Dict[str, np.ndarray] = {}
    names = [name for name in DDPG_LAYERS if name in p]
    if not names:
        raise KeyError(f"no DDPG scope in {sorted(p)}")
    for name in names:
        out[f"{name}.weight"] = np.asarray(p[name]["kernel"]).T
        out[f"{name}.bias"] = np.asarray(p[name]["bias"])
    return {k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32)
            for k, v in out.items()}


LSTM_SCOPE = "OptimizedLSTMCell_0"


def convert_drqn(params: Mapping, state_shape: Sequence[int] = ()
                 ) -> Dict[str, torch.Tensor]:
    """``params`` is ``{"params": {...}}`` or the inner tree of the
    reference's ``DrqnMlpModel`` or ``DrqnCnnModel`` (the CNN's has
    ``Conv_0``; its ``state_shape`` (C, H, W) fixes the ``Dense_0``
    permutation)."""
    p = params["params"] if "params" in params else params
    out: Dict[str, np.ndarray] = {}
    k0 = np.asarray(p["Dense_0"]["kernel"])
    if "Conv_0" in p:
        for i, (name, _cout, _k, _s) in enumerate(CONV_LAYERS):
            out[f"{name}.weight"] = np.asarray(
                p[f"Conv_{i}"]["kernel"]).transpose(3, 2, 0, 1)
            out[f"{name}.bias"] = np.asarray(p[f"Conv_{i}"]["bias"])
        out["fc.weight"] = _dense0_rows_to_cols(
            k0, *torso_out_hw(*state_shape[1:]))
    else:
        out["fc.weight"] = k0.T
    out["fc.bias"] = np.asarray(p["Dense_0"]["bias"])
    out["head.weight"] = np.asarray(p["Dense_1"]["kernel"]).T
    out["head.bias"] = np.asarray(p["Dense_1"]["bias"])
    cell = p[LSTM_SCOPE]
    out["lstm.weight_ih"] = np.concatenate(
        [np.asarray(cell[f"i{g}"]["kernel"]).T for g in GATES])
    out["lstm.weight_hh"] = np.concatenate(
        [np.asarray(cell[f"h{g}"]["kernel"]).T for g in GATES])
    out["lstm.bias"] = np.concatenate(
        [np.asarray(cell[f"h{g}"]["bias"]) for g in GATES])
    return {k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32)
            for k, v in out.items()}


def _flax_leaves_drqn(state_dict, state_shape
                      ) -> List[Tuple[str, torch.Tensor]]:
    """A recurrent model's leaves in ``ravel_pytree`` order: ``Conv_*``
    (the CNN's), ``Dense_0``, ``Dense_1``, then the LSTM's eight gate
    scopes, sorted (``hf``, ``hg``, ``hi``, ``ho``, ``if``, ``ig``, ``ii``,
    ``io``)."""
    leaves = {}
    fc = state_dict["fc.weight"]
    if "conv0.weight" in state_dict:
        for i, (name, _cout, _k, _s) in enumerate(CONV_LAYERS):
            leaves[f"Conv_{i}/bias"] = state_dict[f"{name}.bias"]
            leaves[f"Conv_{i}/kernel"] = state_dict[
                f"{name}.weight"].permute(2, 3, 1, 0)
        oh, ow = torso_out_hw(*state_shape[1:])
        c = fc.shape[1] // (oh * ow)
        leaves["Dense_0/kernel"] = fc.reshape(-1, c, oh, ow).permute(
            2, 3, 1, 0)
    else:
        leaves["Dense_0/kernel"] = fc.t()
    leaves["Dense_0/bias"] = state_dict["fc.bias"]
    leaves["Dense_1/bias"] = state_dict["head.bias"]
    leaves["Dense_1/kernel"] = state_dict["head.weight"].t()
    H = state_dict["lstm.weight_hh"].shape[1]
    for k, g in enumerate(GATES):
        rows = slice(k * H, (k + 1) * H)
        leaves[f"{LSTM_SCOPE}/h{g}/bias"] = state_dict["lstm.bias"][rows]
        leaves[f"{LSTM_SCOPE}/h{g}/kernel"] = state_dict[
            "lstm.weight_hh"][rows].t()
        leaves[f"{LSTM_SCOPE}/i{g}/kernel"] = state_dict[
            "lstm.weight_ih"][rows].t()
    return sorted(leaves.items(), key=lambda kv: kv[0].split("/"))


def _dense(flax_scope: str, torch_name: str):
    return [(f"{flax_scope}/kernel", f"{torch_name}.weight", True),
            (f"{flax_scope}/bias", f"{torch_name}.bias", False)]


def _norm(flax_scope: str, torch_name: str):
    return [(f"{flax_scope}/scale", f"{torch_name}.weight", False),
            (f"{flax_scope}/bias", f"{torch_name}.bias", False)]


def _dtqn_layout(family: str, depth: int) -> List[Tuple[str, str, bool]]:
    """``(flax path, torch key, transposed)`` of every leaf of a DTQN
    model of ``family`` ("mlp", "moe" or "pipe") and ``depth`` blocks:
    a transposed leaf is a kernel whose last two axes swap."""
    if family == "pipe":
        out = (_dense("embed_in", "embed") + _norm("head_ln", "head_ln")
               + _dense("head_q", "head"))
        out += [(f"blocks/{name}", f"blocks.{name}", name.endswith("_k"))
                for name in stacked_shapes(depth, 1)]
    else:
        out = (_dense("Dense_0", "embed") + _dense("Dense_1", "head")
               + _norm("LayerNorm_0", "head_ln"))
        scope = "_MoeBlock" if family == "moe" else "_Block"
        for i in range(depth):
            f, t = f"{scope}_{i}", f"blocks.{i}"
            out += (_norm(f"{f}/LayerNorm_0", f"{t}.ln1")
                    + _dense(f"{f}/Dense_0", f"{t}.qkv")
                    + _dense(f"{f}/Dense_1", f"{t}.proj")
                    + _norm(f"{f}/LayerNorm_1", f"{t}.ln2"))
            if family == "moe":
                out += _dense(f"{f}/moe/router", f"{t}.moe.router")
                out += [(f"{f}/moe/{n}", f"{t}.moe.{n}", False)
                        for n in ("b1", "b2", "w1", "w2")]
            else:
                out += (_dense(f"{f}/Dense_2", f"{t}.ffn1")
                        + _dense(f"{f}/Dense_3", f"{t}.ffn2"))
    out.append(("pos_embed", "pos_embed", False))
    return sorted(out, key=lambda e: e[0].split("/"))


def _dtqn_family(state_dict) -> Tuple[str, int]:
    """``(family, depth)`` of a DTQN state_dict."""
    if "blocks.ln1_s" in state_dict:
        return "pipe", state_dict["blocks.ln1_s"].shape[0]
    family = "moe" if any(".moe." in k for k in state_dict) else "mlp"
    return family, len({k.split(".")[1] for k in state_dict
                        if k.startswith("blocks.")})


def convert_dtqn(params: Mapping) -> Dict[str, torch.Tensor]:
    """``params`` is ``{"params": {...}}`` or the inner tree of the
    reference's ``DtqnMlpModel``, ``DtqnMoeModel`` or
    ``DtqnPipelineModel`` (models/dtqn.py, moe.py, dtqn_pipeline.py): every
    kernel transposed to a torch weight (the stacked ``blocks/*_k``
    layer by layer, the depth axis leading), LayerNorm ``scale`` to
    ``weight``, the MoE's expert tensors as they are."""
    p = params["params"] if "params" in params else params
    if "blocks" in p:
        family, depth = "pipe", np.asarray(p["blocks"]["ln1_s"]).shape[0]
    else:
        family = "moe" if "_MoeBlock_0" in p else "mlp"
        depth = sum(1 for k in p if k.startswith("_"))
    out = {}
    for path, key, transposed in _dtqn_layout(family, depth):
        leaf = p
        for part in path.split("/"):
            leaf = leaf[part]
        leaf = np.asarray(leaf)
        out[key] = np.swapaxes(leaf, -1, -2) if transposed else leaf
    return {k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32)
            for k, v in out.items()}


def _flax_leaves_dtqn(state_dict) -> List[Tuple[str, torch.Tensor]]:
    family, depth = _dtqn_family(state_dict)
    return [(path, state_dict[key].transpose(-1, -2) if transposed
             else state_dict[key])
            for path, key, transposed in _dtqn_layout(family, depth)]


def flax_leaves(state_dict: Mapping[str, torch.Tensor],
                state_shape: Sequence[int]
                ) -> List[Tuple[str, torch.Tensor]]:
    """The port's ``DqnCnnModel``, ``DqnCnnWideModel`` or ``DqnMlpModel``
    state_dict as the reference's flax leaves (``Conv_0/bias``,
    ``Conv_0/kernel``, ...,
    ``Dense_1/kernel``: keys sorted at every level, as ``ravel_pytree``
    orders a flax tree), each a view of the torch tensor in the flax
    layout.  No data is copied.  The wide torso's state_dict (it has
    ``res0.conv0.weight``) and the DDPG model's (``actor_l1.weight``) are
    laid out the same way, and so are the recurrent models' (they have
    ``lstm.weight_ih``) and the transformers' (``pos_embed``)."""
    if "lstm.weight_ih" in state_dict:
        return _flax_leaves_drqn(state_dict, state_shape)
    if "pos_embed" in state_dict:
        return _flax_leaves_dtqn(state_dict)
    if "res0.conv0.weight" in state_dict:
        return _flax_leaves_wide(state_dict, state_shape)
    if "actor_l1.weight" in state_dict:
        # the DDPG scopes sort as DDPG_LAYERS lists them
        out = []
        for name in DDPG_LAYERS:
            out += [(f"{name}/bias", state_dict[f"{name}.bias"]),
                    (f"{name}/kernel", state_dict[f"{name}.weight"].t())]
        return out
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
