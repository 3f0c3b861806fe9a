"""The wide residual Q-network (CONFIGS row 19) as an ``nn.Module`` — the
port of pytorch_distributed_tpu/models/dqn_cnn_wide.py (:1-86,
``_ResBlock`` and ``DqnCnnWideModel``).

An IMPALA-style torso: three sections of ``width``, 2 ``width`` and 2
``width`` channels (``ModelParams.cnn_wide_width``, 128), each a 3x3 SAME
convolution, a 3x3 max pool of stride 2 with SAME padding and two residual
blocks (``relu, conv, relu, conv`` added to the block's input); then ReLU,
a 512-wide dense layer, ReLU and the linear Q head.  84x84 frames become
42, 21 and 11 pixels a side, so the dense layer takes 11 x 11 x 256 =
30,976 inputs.  Parameters are fp32; the forward runs in
``compute_dtype`` (bf16 by default) and returns fp32 Q-values.

It rounds where the flax module rounds: the input is cast, then divided
by ``norm_val`` in the compute type; each convolution and dense product
is rounded before its bias is added (a flax ``Conv``/``Dense`` adds its
bias to the rounded product), and every ReLU and residual sum is in the
compute type.  Flax's SAME max pool pads the window asymmetrically on an
even side (no row above and one below at 84 and 42, one each side at
21), with -inf, so the port pads explicitly before ``max_pool2d``.  The
forward stays NCHW, so its flatten is (c, h, w) where flax's is (h, w,
c); ``convert.convert_dqn_cnn_wide`` permutes ``Dense_0`` to match.

On the learner the module's own forward runs (cuDNN): the reference's
Pallas torso serves ``dqn-cnn`` only (factory.py:693-699).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

FC_WIDTH = 512
SECTIONS = 3
BLOCKS_PER_SECTION = 2


def section_widths(width: int) -> Tuple[int, ...]:
    return (width, 2 * width, 2 * width)


def same_pool_pads(n: int, k: int = 3, s: int = 2) -> Tuple[int, int]:
    """(before, after) padding of a SAME pooling window along a side of
    ``n``, as XLA computes it: the total split with the odd row after."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def torso_out_hw(height: int, width: int) -> Tuple[int, int]:
    """Spatial size after the three pools."""
    for _ in range(SECTIONS):
        height, width = -(-height // 2), -(-width // 2)
    return height, width


def _conv(x: torch.Tensor, conv: nn.Conv2d, cd: torch.dtype) -> torch.Tensor:
    """A 3x3 SAME convolution in ``cd``, rounded before the bias."""
    y = F.conv2d(x, conv.weight.to(cd), None, padding=1)
    return y + conv.bias.to(cd)[:, None, None]


def _max_pool_same(x: torch.Tensor) -> torch.Tensor:
    top, bottom = same_pool_pads(x.shape[-2])
    left, right = same_pool_pads(x.shape[-1])
    x = F.pad(x, (left, right, top, bottom), value=-math.inf)
    return F.max_pool2d(x, 3, stride=2)


class _ResBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv0 = nn.Conv2d(channels, channels, 3, padding=1)
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
        y = _conv(F.relu(x), self.conv0, cd)
        y = _conv(F.relu(y), self.conv1, cd)
        return x + y


class DqnCnnWideModel(nn.Module):
    def __init__(self, action_space: int, state_shape=(4, 84, 84),
                 norm_val: float = 255.0, width: int = 128,
                 orthogonal_init: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.action_space = action_space
        self.state_shape = tuple(state_shape)
        self.norm_val = float(norm_val)
        self.width = int(width)
        self.compute_dtype = compute_dtype
        cin = self.state_shape[0]
        for i, cout in enumerate(section_widths(self.width)):
            setattr(self, f"conv{i}", nn.Conv2d(cin, cout, 3, padding=1))
            for b in range(BLOCKS_PER_SECTION):
                setattr(self, f"res{BLOCKS_PER_SECTION * i + b}",
                        _ResBlock(cout))
            cin = cout
        oh, ow = torso_out_hw(*self.state_shape[1:])
        self.fc = nn.Linear(cin * oh * ow, FC_WIDTH)
        self.head = nn.Linear(FC_WIDTH, action_space)
        if orthogonal_init:
            with torch.no_grad():
                for name, mod in self.named_modules():
                    if isinstance(mod, (nn.Conv2d, nn.Linear)):
                        gain = 1.0 if name == "head" else math.sqrt(2.0)
                        nn.init.orthogonal_(mod.weight, gain=gain,
                                            generator=generator)
                        mod.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        x = x.to(cd) / torch.tensor(self.norm_val, dtype=cd)
        for i in range(SECTIONS):
            x = _max_pool_same(_conv(x, getattr(self, f"conv{i}"), cd))
            for b in range(BLOCKS_PER_SECTION):
                x = getattr(self, f"res{BLOCKS_PER_SECTION * i + b}")(x, cd)
        x = F.relu(x).flatten(1)
        x = F.linear(x, self.fc.weight.to(cd)) + self.fc.bias.to(cd)
        x = F.relu(x)
        q = F.linear(x, self.head.weight.to(cd)) + self.head.bias.to(cd)
        return q.float()
