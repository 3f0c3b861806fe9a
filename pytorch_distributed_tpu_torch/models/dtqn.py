"""Transformer Q-networks over observation windows (DTQN) — the port of
pytorch_distributed_tpu/models/dtqn.py:1-180: ``embed_tokens`` (:38-51),
``q_head`` (:54-61), ``attention_half`` (:64-86), ``_Block`` (:89-103)
and ``DtqnMlpModel`` (:106-180).  models/moe.py and
models/dtqn_pipeline.py build their families on this one.

The model attends causally over a window of recent observations in place
of an LSTM carry.  Two entry points over a params dict of the module's
state-dict keys, as models/drqn.py's:

- ``window_q(params, obs_seq (B, T, *S)) -> (B, T, A)``: one causal pass
  over a fully valid window, the learner's path;
- ``step(params, obs, carry) -> (q, carry')``: the acting path.  The carry
  is ``(window (B, W, *S) fp32, filled (B,) fp32)`` with W = ``window -
  1``, leading-aligned: until the window is full the newest obs goes to
  slot ``filled`` of its row (the reference's ``vmap`` of
  ``dynamic_update_slice``), after that the window rolls; slots at or
  past ``filled`` are masked out of attention and Q is read at ``filled
  - 1``.  ``state_for_segment`` stores the 1-dim placeholder pair: the
  segment window itself is a transformer's context.

The arithmetic is flax's: LayerNorm with epsilon 1e-6, ``nn.gelu``'s tanh
approximation, plain causal attention (ops/ring_attention.py), all fp32.
The module's layout: ``embed`` (flax ``Dense_0``), ``pos_embed``,
``blocks.i`` (``_Block_i``: ``ln1``, ``qkv``, ``proj``, ``ln2``, ``ffn1``,
``ffn2`` for its ``LayerNorm_0``, ``Dense_0``, ``Dense_1``, ``LayerNorm_1``,
``Dense_2``, ``Dense_3``), ``head_ln`` (``LayerNorm_0``) and ``head``
(``Dense_1``); convert.py carries flax's trees across.  Init as flax's,
from an explicit ``torch.Generator``: LeCun-normal kernels, zero biases,
``pos_embed`` normal(0.02), and the Q projection zero, so Q starts at
exactly 0 (reference :54-61).

The sequence-parallel attentions (``with_ring_attention``,
``with_ulysses_attention``) come with the mesh (ROADMAP.md Queue A item
9).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorch_distributed_tpu_torch.models.drqn import lecun_normal_
from pytorch_distributed_tpu_torch.ops.ring_attention import full_attention

Params = Dict[str, torch.Tensor]
Carry = Tuple[torch.Tensor, torch.Tensor]  # (window (B, W, *S), filled (B,))
LN_EPS = 1e-6  # flax nn.LayerNorm's


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def linear(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def layer_norm(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"],
                        p[f"{name}.bias"], eps=LN_EPS)


def attention(qkv: torch.Tensor, heads: int,
              pad_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, T, 3 D) projections -> (B, T, D) causal attention over
    ``heads`` heads, the reference's reshape and transposes."""
    B, T, D3 = qkv.shape
    D = D3 // 3
    qkv = qkv.view(B, T, 3, heads, D // heads)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    o = full_attention(q, k, v, causal=True, key_pad_mask=pad_mask)
    return o.transpose(1, 2).reshape(B, T, D)


def attention_half(p: Params, name: str, x: torch.Tensor, heads: int,
                   pad_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The attention residual of a pre-LN block (reference :64-86), shared
    by the dense and the MoE blocks."""
    y = layer_norm(p, f"{name}.ln1", x)
    o = attention(linear(p, f"{name}.qkv", y), heads, pad_mask)
    return x + linear(p, f"{name}.proj", o)


class AttentionHalf(nn.Module):
    """The attention half's parameters: ``ln1``, ``qkv``, ``proj``."""

    def __init__(self, dim: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Block(AttentionHalf):
    """Pre-LN block: causal attention, then the GELU FFN of 4 dim."""

    def __init__(self, dim: int):
        super().__init__(dim)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ffn1 = nn.Linear(dim, 4 * dim)
        self.ffn2 = nn.Linear(4 * dim, dim)


def block_apply(p: Params, name: str, x: torch.Tensor, heads: int,
                pad_mask: Optional[torch.Tensor]) -> torch.Tensor:
    x = attention_half(p, name, x, heads, pad_mask)
    y = gelu(linear(p, f"{name}.ffn1", layer_norm(p, f"{name}.ln2", x)))
    return x + linear(p, f"{name}.ffn2", y)


class DtqnMlpModel(nn.Module):
    """Dense embed -> causal transformer -> Q head, for low-dim obs."""

    def __init__(self, action_space: int, state_shape, window: int = 32,
                 dim: int = 128, heads: int = 4, depth: int = 2,
                 norm_val: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 init_weights: bool = True):
        super().__init__()
        self.action_space = action_space
        self.state_shape = tuple(state_shape)
        self.window, self.dim, self.heads, self.depth = (
            window, dim, heads, depth)
        self.norm_val = float(norm_val)
        self.compute_dtype = torch.float32
        self.embed = nn.Linear(int(np.prod(self.state_shape)), dim)
        self.pos_embed = nn.Parameter(torch.zeros(window, dim))
        self.blocks = self._make_blocks()
        self.head_ln = nn.LayerNorm(dim, eps=LN_EPS)
        self.head = nn.Linear(dim, action_space)
        if init_weights:
            with torch.no_grad():
                self._init(generator)

    # ---- the family's parts -------------------------------------------

    def _make_blocks(self) -> nn.Module:
        return nn.ModuleList(Block(self.dim) for _ in range(self.depth))

    def _init(self, gen: Optional[torch.Generator]) -> None:
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                lecun_normal_(mod.weight, mod.in_features, gen)
                mod.bias.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=gen)
        self.head.weight.zero_()  # Q starts at exactly 0

    def trunk(self, p: Params, x: torch.Tensor,
              pad_mask: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The block stack: ``(x', aux)``, aux None for a dense stack."""
        for i in range(self.depth):
            x = block_apply(p, f"blocks.{i}", x, self.heads, pad_mask)
        return x, None

    # ---- shared ---------------------------------------------------------

    @property
    def act_window(self) -> int:
        """The acting context: one less than the positional table, since
        a training segment's last position is bootstrap-only (reference
        :117-124)."""
        return self.window - 1

    def zero_carry(self, batch: int, device=None) -> Carry:
        return (torch.zeros((batch, self.act_window, *self.state_shape),
                            device=device),
                torch.zeros((batch,), device=device))

    def state_for_segment(self, carry: Carry, j: int):
        """The stored-state placeholder a segment keeps (reference
        :130-134)."""
        return (np.zeros(1, np.float32), np.zeros(1, np.float32))

    def embed_tokens(self, p: Params, win: torch.Tensor) -> torch.Tensor:
        B, T = win.shape[:2]
        x = win.float() / self.norm_val
        x = linear(p, "embed", x.reshape(B, T, -1))
        return x + p["pos_embed"][:T]

    def q_head(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        return linear(p, "head", layer_norm(p, "head_ln", x))

    def encode(self, p: Params, win: torch.Tensor,
               pad_mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        x, aux = self.trunk(p, self.embed_tokens(p, win), pad_mask)
        return self.q_head(p, x), aux

    def window_q(self, p: Params, obs_seq: torch.Tensor) -> torch.Tensor:
        """The learner's causal Q over a fully valid (B, T, *S) window."""
        return self.encode(p, obs_seq)[0]

    def step(self, p: Params, obs: torch.Tensor,
             carry: Optional[Carry] = None) -> Tuple[torch.Tensor, Carry]:
        """The acting path (reference :136-172): push ``obs`` into the
        leading-aligned window, Q at the newest position."""
        if carry is None:
            carry = self.zero_carry(obs.shape[0], obs.device)
        window, filled = carry
        W = self.act_window
        obs_f = obs.float()
        shifted = torch.cat([window[:, 1:], obs_f[:, None]], dim=1)
        # the row's slot ``filled``, clamped into the window as
        # dynamic_update_slice clamps its start
        slot = torch.arange(W, device=obs.device)
        at = slot[None, :] == filled.long().clamp(max=W - 1)[:, None]
        lead = (-1,) + (1,) * (window.ndim - 2)
        placed = torch.where(at.view(*at.shape, *lead[1:]),
                             obs_f[:, None], window)
        full = (filled >= float(W)).view(*lead, 1)
        window = torch.where(full, shifted, placed)
        filled = torch.clamp(filled + 1.0, max=float(W))
        q_seq, _aux = self.encode(p, window, slot[None, :] < filled[:, None])
        last = (filled - 1.0).long()
        q = torch.gather(q_seq, 1, last.view(-1, 1, 1).expand(
            -1, 1, q_seq.shape[-1]))[:, 0]
        return q, (window, filled)
