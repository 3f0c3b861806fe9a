"""Nature-DQN Q-network as an ``nn.Module`` — the port of
pytorch_distributed_tpu/models/dqn_cnn.py:28-75.

Same architecture (conv 32x8x8/4, 64x4x4/2, 64x3x3/1, FC 512, linear head),
the same ``/norm_val`` input scaling and the same orthogonal init (gain
sqrt(2) for the trunk, 1.0 for the head, zero biases).  Parameters are
fp32; the forward runs in ``compute_dtype`` (bf16 by default) and returns
fp32 Q-values.  Inputs are NCHW uint8 frame stacks, the replay layout, and
the forward stays NCHW (the reference transposes to NHWC for the TPU).
The flatten before ``fc`` is therefore (c, h, w) — ``convert.py`` permutes
the reference's (h, w, c) ``Dense_0`` rows to match.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

# (name, out channels, kernel, stride) — the trunk the torso kernel serves
CONV_LAYERS: Tuple[Tuple[str, int, int, int], ...] = (
    ("conv0", 32, 8, 4), ("conv1", 64, 4, 2), ("conv2", 64, 3, 1),
)
FC_WIDTH = 512


def torso_out_hw(height: int, width: int) -> Tuple[int, int]:
    """Spatial size after the three VALID convolutions."""
    for _name, _out, k, s in CONV_LAYERS:
        height = (height - k) // s + 1
        width = (width - k) // s + 1
    return height, width


class DqnCnnModel(nn.Module):
    def __init__(self, action_space: int, state_shape=(4, 84, 84),
                 norm_val: float = 255.0, orthogonal_init: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.action_space = action_space
        self.state_shape = tuple(state_shape)
        self.norm_val = float(norm_val)
        self.compute_dtype = compute_dtype
        cin = self.state_shape[0]
        for name, cout, k, s in CONV_LAYERS:
            setattr(self, name, nn.Conv2d(cin, cout, k, s))
            cin = cout
        oh, ow = torso_out_hw(*self.state_shape[1:])
        self.fc = nn.Linear(cin * oh * ow, FC_WIDTH)
        self.head = nn.Linear(FC_WIDTH, action_space)
        if orthogonal_init:
            with torch.no_grad():
                for name, mod in self.named_children():
                    gain = 1.0 if name == "head" else math.sqrt(2.0)
                    nn.init.orthogonal_(mod.weight, gain=gain,
                                        generator=generator)
                    mod.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        x = x.to(cd) / self.norm_val
        for name, _cout, _k, s in CONV_LAYERS:
            conv = getattr(self, name)
            x = F.relu(F.conv2d(x, conv.weight.to(cd), conv.bias.to(cd),
                                stride=s))
        x = F.relu(F.linear(x.flatten(1), self.fc.weight.to(cd),
                            self.fc.bias.to(cd)))
        q = F.linear(x, self.head.weight.to(cd), self.head.bias.to(cd))
        return q.float()
