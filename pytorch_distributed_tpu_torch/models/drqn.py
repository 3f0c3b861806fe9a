"""Recurrent Q-networks (the R2D2 family) as ``nn.Module``s — the port of
pytorch_distributed_tpu/models/drqn.py:1-96.

- ``DrqnMlpModel``: ``/norm_val``, one ReLU layer of ``hidden_dim``
  (``fc``), an LSTM core of ``lstm_dim`` (``lstm``) and the linear Q head
  (``head``), all fp32;
- ``DrqnCnnModel``: the Nature-DQN convolutions (``conv0``-``conv2``) and a
  ReLU layer of ``lstm_dim`` (``fc``) computed in ``compute_dtype`` (bf16
  by default) with the module's own cuDNN convolutions, then the LSTM and
  the Q head in fp32.  The JAX package's DRQN torso is ``nn.Conv`` /
  ``nn.Dense`` (no Pallas kernel), so the GEMM kernel of ops/cuda_torso.py
  does not serve it.

The LSTM is flax's ``OptimizedLSTMCell``: ``i, f, o = sigmoid(.)``, ``g =
tanh(.)`` of ``x W_i + h W_h + b``, ``c' = f c + i g``, ``h' = o
tanh(c')``, with one bias (the recurrent kernels'), its gates and carry in
fp32.  The port keeps the four gates stacked in ``(i, f, g, o)`` order:
``lstm.weight_ih`` (4H, in), ``lstm.weight_hh`` (4H, H) and ``lstm.bias``
(4H,); ``convert.convert_drqn`` carries flax's per-gate ``ii``..``io`` and
``hi``..``ho`` scopes across.  The carry is flax's ``(c, h)`` pair.

Two entry points over a params dict of the module's state-dict keys:

- ``step(params, obs, carry) -> (q, carry')``: one recurrent step on a
  batch, the reference's ``apply``; ``carry`` None starts from zeros;
- ``sequence(params, obs_tm, carry) -> (q_tm, carry')`` over a time-major
  (T, B, ...) sequence: the learner's unroll.  The torso is not recurrent,
  so it runs over all T*B frames at once, the input projections of every
  step are one product, and only ``h W_h`` and the gates run step by step;
  the Q head then runs over the T*B hidden states at once.  The same math
  as the reference's ``unroll`` (ops/sequence_losses.py:72-81), which
  scans the step.

Init as flax's defaults: LeCun-normal kernels (truncated normal), zero
biases, orthogonal recurrent kernels (one per gate), from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorch_distributed_tpu_torch.models.dqn_cnn import (
    CONV_LAYERS, torso_out_hw,
)

Params = Dict[str, torch.Tensor]
Carry = Tuple[torch.Tensor, torch.Tensor]  # (c, h)
GATES = ("i", "f", "g", "o")


class LstmCell(nn.Module):
    """The LSTM's parameters, gates stacked (i, f, g, o)."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, in_dim))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias = nn.Parameter(torch.zeros(4 * hidden))


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  gen: Optional[torch.Generator]) -> None:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std,
                          generator=gen)


def lstm_cell(gates: torch.Tensor, c: torch.Tensor) -> Carry:
    """One step of the gates' nonlinearity: ``gates`` (B, 4H) is ``x W_i
    + h W_h + b``; returns ``(c', h')``."""
    H = c.shape[-1]
    s = torch.sigmoid(gates)
    g = torch.tanh(gates[:, 2 * H:3 * H])
    c2 = torch.addcmul(s[:, H:2 * H] * c, s[:, :H], g)
    return c2, s[:, 3 * H:] * torch.tanh(c2)


def lstm_unroll(params: Params, x_tm: torch.Tensor, carry: Carry
                ) -> Tuple[torch.Tensor, Carry]:
    """The LSTM over a time-major input (T, B, D): the T input
    projections in one product, then the recurrence.  Returns ``(h_tm (T,
    B, H), (c_T, h_T))``."""
    T, B = x_tm.shape[:2]
    w_hh = params["lstm.weight_hh"].t()
    xp = F.linear(x_tm.reshape(T * B, -1), params["lstm.weight_ih"],
                  params["lstm.bias"]).view(T, B, -1)
    c, h = carry
    hs = []
    for t in range(T):
        c, h = lstm_cell(torch.addmm(xp[t], h, w_hh), c)
        hs.append(h)
    return torch.stack(hs), (c, h)


class _Drqn(nn.Module):
    """What both models share: the carry, the step and the sequence."""

    lstm_dim: int

    def zero_carry(self, batch: int, device=None) -> Carry:
        z = torch.zeros((batch, self.lstm_dim), device=device)
        return (z, z.clone())

    def state_for_segment(self, carry, j: int):
        """The stored state a segment keeps: env j's (c, h) row."""
        return (carry[0][j], carry[1][j])

    def torso(self, params: Params, obs: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def step(self, params: Params, obs: torch.Tensor,
             carry: Optional[Carry] = None) -> Tuple[torch.Tensor, Carry]:
        if carry is None:
            carry = self.zero_carry(obs.shape[0], obs.device)
        x = self.torso(params, obs)
        gates = F.linear(x, params["lstm.weight_ih"]) + F.linear(
            carry[1], params["lstm.weight_hh"], params["lstm.bias"])
        carry = lstm_cell(gates, carry[0])
        q = F.linear(carry[1], params["head.weight"], params["head.bias"])
        return q, carry

    def sequence(self, params: Params, obs_tm: torch.Tensor, carry: Carry
                 ) -> Tuple[torch.Tensor, Carry]:
        T, B = obs_tm.shape[:2]
        x = self.torso(params, obs_tm.reshape(T * B, *obs_tm.shape[2:]))
        h_tm, carry = lstm_unroll(params, x.view(T, B, -1), carry)
        q = F.linear(h_tm, params["head.weight"], params["head.bias"])
        return q, carry

    @torch.no_grad()
    def _init_lstm(self, in_dim: int, gen) -> None:
        H = self.lstm_dim
        lecun_normal_(self.lstm.weight_ih, in_dim, gen)
        for k in range(4):  # one orthogonal matrix per gate, as flax's
            nn.init.orthogonal_(self.lstm.weight_hh[k * H:(k + 1) * H],
                                generator=gen)


class DrqnMlpModel(_Drqn):
    def __init__(self, action_space: int, in_dim: int,
                 hidden_dim: int = 256, lstm_dim: int = 256,
                 norm_val: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 init_weights: bool = True):
        super().__init__()
        self.action_space = action_space
        self.lstm_dim = lstm_dim
        self.norm_val = float(norm_val)
        self.compute_dtype = torch.float32
        self.fc = nn.Linear(in_dim, hidden_dim)
        self.lstm = LstmCell(hidden_dim, lstm_dim)
        self.head = nn.Linear(lstm_dim, action_space)
        if init_weights:
            with torch.no_grad():
                for mod in (self.fc, self.head):
                    lecun_normal_(mod.weight, mod.in_features, generator)
                    mod.bias.zero_()
            self._init_lstm(hidden_dim, generator)

    def torso(self, params: Params, obs: torch.Tensor) -> torch.Tensor:
        x = obs.float() / self.norm_val
        x = x.reshape(x.shape[0], -1)
        return F.relu(F.linear(x, params["fc.weight"], params["fc.bias"]))


class DrqnCnnModel(_Drqn):
    def __init__(self, action_space: int, state_shape=(4, 84, 84),
                 lstm_dim: int = 512, norm_val: float = 255.0,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None,
                 init_weights: bool = True):
        super().__init__()
        self.action_space = action_space
        self.state_shape = tuple(state_shape)
        self.lstm_dim = lstm_dim
        self.norm_val = float(norm_val)
        self.compute_dtype = compute_dtype
        cin = self.state_shape[0]
        for name, cout, k, s in CONV_LAYERS:
            setattr(self, name, nn.Conv2d(cin, cout, k, s))
            cin = cout
        oh, ow = torso_out_hw(*self.state_shape[1:])
        self.fc = nn.Linear(cin * oh * ow, lstm_dim)
        self.lstm = LstmCell(lstm_dim, lstm_dim)
        self.head = nn.Linear(lstm_dim, action_space)
        if init_weights:
            with torch.no_grad():
                for name, _cout, k, _s in CONV_LAYERS:
                    conv = getattr(self, name)
                    lecun_normal_(conv.weight, conv.in_channels * k * k,
                                  generator)
                    conv.bias.zero_()
                for mod in (self.fc, self.head):
                    lecun_normal_(mod.weight, mod.in_features, generator)
                    mod.bias.zero_()
            self._init_lstm(lstm_dim, generator)

    def torso(self, params: Params, obs: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        x = obs.to(cd) / self.norm_val
        for name, _cout, _k, s in CONV_LAYERS:
            x = F.relu(F.conv2d(x, params[f"{name}.weight"].to(cd),
                                params[f"{name}.bias"].to(cd), stride=s))
        x = F.relu(F.linear(x.flatten(1), params["fc.weight"].to(cd),
                            params["fc.bias"].to(cd)))
        return x.float()  # the LSTM's gates and state stay fp32
