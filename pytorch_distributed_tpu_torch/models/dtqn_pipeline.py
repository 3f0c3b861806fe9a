"""The stacked-block DTQN — the port of
pytorch_distributed_tpu/models/dtqn_pipeline.py: ``block_forward``
(:43-68), ``scan_blocks`` (:71-80), the stacked parameters
(``_StackedBlockParams``, :83-115) and ``DtqnPipelineModel`` (:118-165:
its ``embed`` and ``head``).

Every block's parameters live in one tensor a kind with a leading
``depth`` axis (``blocks.ln1_s``, ``blocks.qkv_k``, ...), and the stack
runs as a loop over that axis, the reference's ``lax.scan``.  The block
math is written once on raw parameters (``block_forward``), with its own
LayerNorm, ``(h - mean) rsqrt(var + 1e-6)`` over the biased variance, and
flax's tanh GELU.  The stacked kernels are kept as torch weights, (depth,
out, in), each layer's the transpose of the reference's (in, out) slice;
their LeCun-normal init takes a layer's fan-in, as the reference's
``vmap``-ed init does (:98-100).  ``embed``, ``pos_embed``, ``head_ln``
and ``head`` are the dense family's (flax ``embed_in``, ``pos_embed``,
``head_ln``, ``head_q``).

The reference shards the depth axis over its mesh's ``pp`` axis
(parallel/pipeline.py ``pipelined_window_apply``); that comes with the
mesh (ROADMAP.md Queue A item 9).  On one device it scans, as here.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorch_distributed_tpu_torch.models.drqn import lecun_normal_
from pytorch_distributed_tpu_torch.models.dtqn import (
    DtqnMlpModel, Params, attention, gelu,
)


def stacked_shapes(depth: int, dim: int) -> Dict[str, tuple]:
    """Each stacked kind's shape, kernels (depth, out, in), in the order
    of the reference's ``_StackedBlockParams``."""
    D, H = dim, 4 * dim
    return {"ln1_s": (depth, D), "ln1_b": (depth, D),
            "qkv_k": (depth, 3 * D, D), "qkv_b": (depth, 3 * D),
            "proj_k": (depth, D, D), "proj_b": (depth, D),
            "ln2_s": (depth, D), "ln2_b": (depth, D),
            "ffn1_k": (depth, H, D), "ffn1_b": (depth, H),
            "ffn2_k": (depth, D, H), "ffn2_b": (depth, D)}


def _ln(h: torch.Tensor, scale: torch.Tensor,
        bias: torch.Tensor) -> torch.Tensor:
    mu = h.mean(-1, keepdim=True)
    var = h.var(-1, unbiased=False, keepdim=True)
    return (h - mu) * torch.rsqrt(var + 1e-6) * scale + bias


def block_forward(p: Dict[str, torch.Tensor], x: torch.Tensor, *,
                  heads: int, key_pad_mask: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """One pre-LN block on one layer's slice ``p`` (``ln1_s``, ``ln1_b``,
    ``qkv_k``, ``qkv_b``, ``proj_k``, ``proj_b``, ``ln2_s``, ``ln2_b``,
    ``ffn1_k``, ``ffn1_b``, ``ffn2_k``, ``ffn2_b``)."""
    y = _ln(x, p["ln1_s"], p["ln1_b"])
    o = attention(F.linear(y, p["qkv_k"], p["qkv_b"]), heads, key_pad_mask)
    x = x + F.linear(o, p["proj_k"], p["proj_b"])
    y = gelu(F.linear(_ln(x, p["ln2_s"], p["ln2_b"]), p["ffn1_k"],
                      p["ffn1_b"]))
    return x + F.linear(y, p["ffn2_k"], p["ffn2_b"])


def scan_blocks(stacked: Dict[str, torch.Tensor], x: torch.Tensor, *,
                heads: int, key_pad_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """The stack in order over the leading layer axis."""
    for layer in range(next(iter(stacked.values())).shape[0]):
        x = block_forward({k: v[layer] for k, v in stacked.items()}, x,
                          heads=heads, key_pad_mask=key_pad_mask)
    return x


class StackedBlocks(nn.Module):
    """The block stack's parameters, one tensor a kind."""

    def __init__(self, dim: int, depth: int):
        super().__init__()
        for name, shape in stacked_shapes(depth, dim).items():
            setattr(self, name, nn.Parameter(torch.zeros(shape)))


class DtqnPipelineModel(DtqnMlpModel):
    """DTQN whose block stack is one set of stacked tensors, ``blocks.*``;
    the same window carry, ``window_q`` and ``step`` as
    ``DtqnMlpModel``."""

    def _make_blocks(self) -> nn.Module:
        return StackedBlocks(self.dim, self.depth)

    def _init(self, gen: Optional[torch.Generator]) -> None:
        super()._init(gen)  # embed, head, pos_embed
        b = self.blocks
        b.ln1_s.fill_(1.0)
        b.ln2_s.fill_(1.0)
        for name in ("qkv_k", "proj_k", "ffn1_k", "ffn2_k"):
            w = getattr(b, name)
            lecun_normal_(w, w.shape[-1], gen)  # a layer's fan-in

    def trunk(self, p: Params, x: torch.Tensor,
              pad_mask: Optional[torch.Tensor]):
        stacked = {name: p[f"blocks.{name}"]
                   for name in stacked_shapes(0, 0)}
        return scan_blocks(stacked, x, heads=self.heads,
                           key_pad_mask=pad_mask), None
