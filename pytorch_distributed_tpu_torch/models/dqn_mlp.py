"""Low-dim MLP Q-network as an ``nn.Module`` — the port of
pytorch_distributed_tpu/models/dqn_mlp.py:15-34: three hidden ReLU layers
of ``hidden_dim``, the ``/norm_val`` input scaling, orthogonal init (gain
sqrt(2) for the hidden layers, 1.0 for the head, zero biases) and fp32
compute (the reference builds it with its default ``compute_dtype``,
factory.py:430-435).  ``pallas_torso`` does not apply to it (reference
factory.py:693-699).  ``convert.convert_dqn_mlp`` carries the flax params
across.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

HIDDEN_LAYERS = ("fc0", "fc1", "fc2")


class DqnMlpModel(nn.Module):
    def __init__(self, action_space: int, in_dim: int,
                 hidden_dim: int = 256, norm_val: float = 1.0,
                 orthogonal_init: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.action_space = action_space
        self.norm_val = float(norm_val)
        width = in_dim
        for name in HIDDEN_LAYERS:
            setattr(self, name, nn.Linear(width, hidden_dim))
            width = hidden_dim
        self.head = nn.Linear(width, action_space)
        if orthogonal_init:
            with torch.no_grad():
                for name, mod in self.named_children():
                    gain = 1.0 if name == "head" else math.sqrt(2.0)
                    nn.init.orthogonal_(mod.weight, gain=gain,
                                        generator=generator)
                    mod.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float() / self.norm_val
        x = x.reshape(x.shape[0], -1)
        for name in HIDDEN_LAYERS:
            x = F.relu(getattr(self, name)(x))
        return self.head(x)
