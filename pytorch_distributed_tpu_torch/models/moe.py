"""The mixture-of-experts DTQN — the port of
pytorch_distributed_tpu/models/moe.py: ``_top_k_dispatch`` (:52-91),
``MoeFfn`` (:94-146), ``_MoeBlock`` (:149-172), ``DtqnMoeModel``
(:175-199) and ``window_q_with_aux`` (:202-227).

Each block's FFN is a top-k routed mixture of ``num_experts`` GELU FFNs
(dim -> 4 dim -> dim), with the Switch/GShard dataflow of the reference:

- the router is one linear layer to E logits, softmaxed; each token picks
  its top k experts, the gates renormalised over the k;
- each expert takes at most C = ceil(capacity_factor k T / E) tokens a
  batch row, T the model's static ``window`` (so acting and learning
  route alike: 26 slots at window 81, E 8, k 2, factor 1.25); slots go
  in (rank, time) order, all rank-0 choices before any rank-1 one, and
  an overflowing token is dropped for that expert;
- dispatch and combine are one-hot (B, T, E, C) tensors around the
  expert-batched products (E-leading kernels ``w1`` (E, D, H), ``w2``
  (E, H, D), in flax's layout);
- the aux loss is the Switch load-balancing term E sum_e f_e P_e (f_e the
  share of tokens whose top-1 choice is e, P_e the mean router
  probability); ``window_q_with_aux`` returns its mean over the blocks,
  which the train step adds with ``moe_aux_weight``.

One device holds every expert: the reference's ``ep`` sharding
(parallel/expert_parallel.py) comes with the mesh (ROADMAP.md Queue A
item 9).  ``jax.nn.one_hot`` gives an all-zero row for an index past the
capacity, which is how an overflow drops out of ``slot_hot``;
``F.one_hot`` raises there, so the slot one-hot compares against
``arange(capacity)`` instead.  The expert kernels' LeCun-normal init
counts E in the fan-in, as flax's does on an (E, D, H) kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorch_distributed_tpu_torch.models.drqn import lecun_normal_
from pytorch_distributed_tpu_torch.models.dtqn import (
    AttentionHalf, DtqnMlpModel, LN_EPS, Params, attention_half, gelu,
    layer_norm, linear,
)


def moe_capacity(capacity_factor: float, top_k: int, tokens: int,
                 num_experts: int) -> int:
    """Slots an expert a batch row (reference :115-116)."""
    return max(int(-(-capacity_factor * top_k * tokens // num_experts)), 1)


def top_k_dispatch(probs: torch.Tensor, top_k: int, capacity: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dispatch (B, T, E, C) in {0, 1}, combine (B, T, E, C), f_top1
    (B, T, E))`` from the router's probabilities ``probs`` (B, T, E): token
    t of row b takes slot c of expert e, that slot's gate, and the rank-0
    choice before any drop."""
    B, T, E = probs.shape
    top_p, top_i = torch.topk(probs, top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    slots = torch.arange(capacity, device=probs.device)
    dispatch = probs.new_zeros((B, T, E, capacity))
    combine = probs.new_zeros((B, T, E, capacity))
    count = probs.new_zeros((B, E))  # slots already claimed
    f_top1 = None
    for r in range(top_k):
        mask_r = F.one_hot(top_i[..., r], E).to(probs.dtype)
        if r == 0:
            f_top1 = mask_r
        # this rank's slot: the claimed slots plus its exclusive running
        # count along time
        pos = count[:, None, :] + torch.cumsum(mask_r, dim=1) - mask_r
        keep = mask_r * (pos < capacity)
        slot_hot = (pos.long()[..., None] == slots).to(probs.dtype)
        dispatch = dispatch + keep[..., None] * slot_hot
        combine = combine + (keep * top_p[..., r:r + 1])[..., None] \
            * slot_hot
        count = count + mask_r.sum(1)
    return dispatch, combine, f_top1


class MoeFfn(nn.Module):
    """The router (``router``) and the E experts' stacked kernels."""

    def __init__(self, dim: int, num_experts: int = 8, hidden_mult: int = 4):
        super().__init__()
        H = hidden_mult * dim
        self.router = nn.Linear(dim, num_experts)
        self.w1 = nn.Parameter(torch.zeros(num_experts, dim, H))
        self.b1 = nn.Parameter(torch.zeros(num_experts, H))
        self.w2 = nn.Parameter(torch.zeros(num_experts, H, dim))
        self.b2 = nn.Parameter(torch.zeros(num_experts, dim))


def moe_ffn(p: Params, name: str, x: torch.Tensor, top_k: int,
            capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y (B, T, D), aux)`` of one routed FFN (reference :118-146)."""
    w1, b1 = p[f"{name}.w1"], p[f"{name}.b1"]
    w2, b2 = p[f"{name}.w2"], p[f"{name}.b2"]
    E = w1.shape[0]
    probs = torch.softmax(linear(p, f"{name}.router", x), dim=-1)
    dispatch, combine, f_top1 = top_k_dispatch(probs, min(top_k, E),
                                               capacity)
    xin = torch.einsum("btec,btd->becd", dispatch, x)
    h = gelu(torch.einsum("becd,edh->bech", xin, w1) + b1[None, :, None, :])
    out = torch.einsum("bech,ehd->becd", h, w2) + b2[None, :, None, :]
    y = torch.einsum("becd,btec->btd", out, combine)
    aux = E * torch.sum(f_top1.mean((0, 1)) * probs.mean((0, 1)))
    return y, aux


class MoeBlock(AttentionHalf):
    """Pre-LN block: the shared attention half, then ``ln2`` and the routed
    FFN ``moe``."""

    def __init__(self, dim: int, num_experts: int):
        super().__init__(dim)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.moe = MoeFfn(dim, num_experts)


class DtqnMoeModel(DtqnMlpModel):
    """DTQN with every block's FFN a routed expert mixture; the same
    window carry, ``window_q`` and ``step`` as ``DtqnMlpModel``."""

    def __init__(self, action_space: int, state_shape, window: int = 32,
                 dim: int = 128, heads: int = 4, depth: int = 2,
                 norm_val: float = 1.0, num_experts: int = 8,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 generator: Optional[torch.Generator] = None,
                 init_weights: bool = True):
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity = moe_capacity(capacity_factor,
                                     min(top_k, num_experts), window,
                                     num_experts)
        super().__init__(action_space, state_shape, window, dim, heads,
                         depth, norm_val, generator, init_weights)

    def _make_blocks(self) -> nn.Module:
        return nn.ModuleList(MoeBlock(self.dim, self.num_experts)
                             for _ in range(self.depth))

    def _init(self, gen: Optional[torch.Generator]) -> None:
        super()._init(gen)
        for blk in self.blocks:
            E, D, H = blk.moe.w1.shape
            lecun_normal_(blk.moe.w1, E * D, gen)  # flax counts E in
            lecun_normal_(blk.moe.w2, E * H, gen)

    def trunk(self, p: Params, x: torch.Tensor,
              pad_mask: Optional[torch.Tensor]):
        auxes = []
        for i in range(self.depth):
            name = f"blocks.{i}"
            x = attention_half(p, name, x, self.heads, pad_mask)
            y, aux = moe_ffn(p, f"{name}.moe", layer_norm(p, f"{name}.ln2",
                                                          x),
                             self.top_k, self.capacity)
            x = x + y
            auxes.append(aux)
        return x, torch.stack(auxes).mean()

    def window_q_with_aux(self, p: Params, obs_seq: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(q, aux)``: the learner's apply with the blocks' mean aux
        loss (reference :202-227)."""
        return self.encode(p, obs_seq)
