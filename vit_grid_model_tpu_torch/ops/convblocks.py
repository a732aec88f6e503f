"""SimVP's conv blocks: BasicConv2d, ConvSC, GroupConv2d and Inception.

Counterpart of ``vit_grid_model_tpu/ops/convblocks.py`` (the reference's
``modules.py:4-65``), in NCHW on ``nn.Conv2d``, ``nn.ConvTranspose2d`` and
``nn.GroupNorm``, with the reference's module names (the keys of
``core/export.py::export_simvp``).  Details kept:

* the transposed conv has ``output_padding = stride // 2``;
* BasicConv2d is a conv, a 2-group norm and the activation (every SimVP
  block has ``act_norm`` on); ConvSC is a 3x3 one with padding 1, and
  stride 1 forces a plain conv;
* GroupConv2d's groups fall back to 1 when ``c_in`` does not divide; the
  conv and the norm over ``c_out`` take the same count;
* LeakyReLU's slope is 0.2;
* Inception sums its branches.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import Tensor, nn

LEAKY_SLOPE = 0.2


class BasicConv2d(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel: int, *, stride: int,
                 padding: int, transpose: bool = False):
        super().__init__()
        if transpose:
            self.conv = nn.ConvTranspose2d(
                c_in, c_out, kernel, stride=stride, padding=padding,
                output_padding=stride // 2)
        else:
            self.conv = nn.Conv2d(c_in, c_out, kernel, stride=stride,
                                  padding=padding)
        self.norm = nn.GroupNorm(2, c_out)

    def forward(self, x: Tensor) -> Tensor:
        return F.leaky_relu(self.norm(self.conv(x)), LEAKY_SLOPE)


class ConvSC(nn.Module):
    def __init__(self, c_in: int, c_out: int, *, stride: int,
                 transpose: bool = False):
        super().__init__()
        self.conv = BasicConv2d(c_in, c_out, 3, stride=stride, padding=1,
                                transpose=transpose and stride != 1)

    def forward(self, x: Tensor) -> Tensor:
        return self.conv(x)


def effective_groups(c_in: int, groups: int) -> int:
    """GroupConv2d's groups: 1 when ``c_in`` does not divide."""
    return groups if c_in % groups == 0 else 1


class GroupConv2d(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel: int, groups: int):
        super().__init__()
        groups = effective_groups(c_in, groups)
        self.conv = nn.Conv2d(c_in, c_out, kernel, padding=kernel // 2,
                              groups=groups)
        self.norm = nn.GroupNorm(groups, c_out)

    def forward(self, x: Tensor) -> Tensor:
        return F.leaky_relu(self.norm(self.conv(x)), LEAKY_SLOPE)


class Inception(nn.Module):
    def __init__(self, c_in: int, c_hid: int, c_out: int,
                 incep_ker: Sequence[int] = (3, 5, 7, 11), groups: int = 8):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, c_hid, 1)
        self.layers = nn.ModuleList(GroupConv2d(c_hid, c_out, k, groups)
                                    for k in incep_ker)

    def forward(self, x: Tensor) -> Tensor:
        x = self.conv1(x)
        y = 0.0
        for layer in self.layers:
            y = y + layer(x)
        return y
