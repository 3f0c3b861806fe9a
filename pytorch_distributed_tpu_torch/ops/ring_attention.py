"""Plain causal softmax attention — the port of ``full_attention`` in
pytorch_distributed_tpu/ops/ring_attention.py:36-54, the single-device
attention the DTQN family (models/dtqn.py, models/moe.py,
models/dtqn_pipeline.py) runs on one card.

Op for op as the reference's: one einsum for the scores, the scale
``head_dim ** -0.5``, the causal mask ``tril(k = tk - tq)``, the key pad
mask, both applied by ``where`` with ``NEG_INF`` = -1e30 (not -inf, so a
row with every key masked still gives a finite softmax), the softmax and
the value einsum.  ``scaled_dot_product_attention`` is not used: its
masking and accumulation differ from the reference's.

The sequence-parallel ``ring_attention`` (and ops/ulysses_attention.py)
come with the mesh (ROADMAP.md Queue A item 9): one H100 is a world of
one, where the reference builds no mesh.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True,
                   key_pad_mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """(B, H, T, D) in and out.  ``key_pad_mask`` (B, Tk) bool marks the
    valid keys (the acting window's filled slots)."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    tq, tk = scores.shape[-2], scores.shape[-1]
    if causal:
        mask = torch.ones((tq, tk), dtype=torch.bool,
                          device=scores.device).tril(tk - tq)
        scores = torch.where(mask, scores, NEG_INF)
    if key_pad_mask is not None:
        scores = torch.where(key_pad_mask[:, None, None, :], scores, NEG_INF)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1), v)
