"""The DDPG actor-critic as one ``nn.Module`` — the port of
pytorch_distributed_tpu/models/ddpg_mlp.py:

- actor: state -> 300 tanh -> 200 tanh -> tanh(d), an action in [-1, 1]
  (:56-60);
- critic: state -> 400 tanh, the action concatenated -> 300 tanh -> 1,
  squeezed (:62-67);
- init (:19-55): the hidden layers' weights fan-in uniform,
  ``variance_scaling(1/3, fan_in, uniform)``, that is U(-1/sqrt(fan_in),
  1/sqrt(fan_in)), with zero biases; the output layers' weights
  U(-3e-3, 3e-3) and biases U(0, 3e-3) (flax's ``uniform(scale)`` draws
  from [0, scale)), all from an explicit ``torch.Generator``;
- fp32 throughout, as the reference's (its ``Dense`` layers take no
  compute dtype).

The layers carry the reference's flax scope names (``actor_l1`` ...
``critic_out``), so ``convert.convert_ddpg_mlp`` maps scope to module
one to one.  ``actor_apply(params, obs)`` and ``critic_apply(params, obs,
action)`` run either net over a params dict of the module's state-dict
keys: the learner's steps differentiate through them.  A weight of three
dimensions is a stack of M copies (the megabatch group step): the input is
then (M, B, ...) and row group m reads copy m, one batched product a
layer.  No GEMM kernel serves these layers: the JAX package computes them
with ``flax.linen.Dense``, outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

ACTOR_LAYERS = ("actor_l1", "actor_l2", "actor_out")
CRITIC_LAYERS = ("critic_l1", "critic_l2", "critic_out")
OUT_SCALE = 3e-3

Params = Dict[str, torch.Tensor]


def _linear(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if w.dim() == 2:
        return F.linear(x, w, b)
    # (M, out, in) copies over (M, B, in) rows
    return torch.baddbmm(b.unsqueeze(1), x, w.transpose(1, 2))


def _norm(x: torch.Tensor, norm_val: float, stacked: bool) -> torch.Tensor:
    x = x.float() / norm_val
    lead = 2 if stacked else 1
    return x.reshape(*x.shape[:lead], -1)


def actor_apply(params: Params, obs: torch.Tensor,
                norm_val: float = 1.0) -> torch.Tensor:
    """The deterministic policy: actions (B, d), or (M, B, d) on stacked
    weights."""
    x = _norm(obs, norm_val, params["actor_l1.weight"].dim() == 3)
    x = torch.tanh(_linear(x, params, "actor_l1"))
    x = torch.tanh(_linear(x, params, "actor_l2"))
    return torch.tanh(_linear(x, params, "actor_out"))


def critic_apply(params: Params, obs: torch.Tensor, action: torch.Tensor,
                 norm_val: float = 1.0) -> torch.Tensor:
    """Q(s, a): (B,), or (M, B) on stacked weights."""
    stacked = params["critic_l1.weight"].dim() == 3
    x = _norm(obs, norm_val, stacked)
    h = torch.tanh(_linear(x, params, "critic_l1"))
    a = action.reshape(*action.shape[:2 if stacked else 1], -1)
    h = torch.cat([h, a.to(h.dtype)], dim=-1)
    h = torch.tanh(_linear(h, params, "critic_l2"))
    return _linear(h, params, "critic_out").squeeze(-1)


class DdpgMlpModel(nn.Module):
    def __init__(self, action_dim: int, in_dim: int, norm_val: float = 1.0,
                 actor_hidden: Tuple[int, int] = (300, 200),
                 critic_hidden: Tuple[int, int] = (400, 300),
                 generator: Optional[torch.Generator] = None,
                 init_weights: bool = True):
        super().__init__()
        self.action_dim = action_dim
        self.norm_val = float(norm_val)
        a1, a2 = actor_hidden
        c1, c2 = critic_hidden
        self.actor_l1 = nn.Linear(in_dim, a1)
        self.actor_l2 = nn.Linear(a1, a2)
        self.actor_out = nn.Linear(a2, action_dim)
        self.critic_l1 = nn.Linear(in_dim, c1)
        self.critic_l2 = nn.Linear(c1 + action_dim, c2)
        self.critic_out = nn.Linear(c2, 1)
        if init_weights:
            self._init(generator)

    @torch.no_grad()
    def _init(self, gen: Optional[torch.Generator]) -> None:
        for name, mod in self.named_children():
            if name.endswith("_out"):
                mod.weight.uniform_(-OUT_SCALE, OUT_SCALE, generator=gen)
                mod.bias.uniform_(0.0, OUT_SCALE, generator=gen)
            else:
                lim = 1.0 / math.sqrt(mod.in_features)
                mod.weight.uniform_(-lim, lim, generator=gen)
                mod.bias.zero_()

    def _params(self) -> Params:
        return dict(self.named_parameters())

    def forward_actor(self, x: torch.Tensor) -> torch.Tensor:
        return actor_apply(self._params(), x, self.norm_val)

    def forward_critic(self, x: torch.Tensor,
                       a: torch.Tensor) -> torch.Tensor:
        return critic_apply(self._params(), x, a, self.norm_val)
