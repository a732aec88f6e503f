"""Normalization components of the legacy models: RevIN, DishTS and
TimeEncode.

Counterpart of ``vit_grid_model_tpu/models/normalizers.py``.  The modules
hold only parameters (keys ``affine_weight``/``affine_bias``,
``reduce_mlayer``/``gamma``/``beta`` and ``w.weight``/``w.bias``, as the
reference's); the statistics are values the caller passes back in, as in
the JAX package.  Quirks kept:

* RevIN statistics: the NaN-propagating mean over the reduce axes with the
  NaN-masked variance; a slice holding a NaN falls back to the defaults for
  both statistics, and so does a zero stdev;
* ``denorm`` divides by ``affine_weight + eps**2``, not ``+ eps``;
* ``denorm2`` slices the statistics and the affine to the output's width;
* DishTS's ``norm`` takes its statistics from its input, and ``denorm``
  reuses those of the last ``norm`` call, which ``norm`` returns;
* DishTS's GELU is the exact (erf) one;
* TimeEncode's frequencies start at ``1 / alpha ** linspace(0, alpha - 1,
  d)`` with ``alpha = int(sqrt(d))``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn


class RevINStats(NamedTuple):
    mean: Tensor      # (..., 1, C), kept dims over the reduce axes
    stdev: Tensor


def revin_statistics(x: Tensor, *, default_mean: float, default_std: float,
                     eps: float = 1e-5) -> RevINStats:
    """NaN-aware statistics over every axis but the first and the last."""
    axes = tuple(range(1, x.ndim - 1))
    mask = ~torch.isnan(x)
    counts = mask.sum(dim=axes, keepdim=True)
    mean = x.mean(dim=axes, keepdim=True)              # NaN-propagating
    sq = torch.where(mask, torch.square(x - mean), torch.zeros_like(x))
    var = sq.sum(dim=axes, keepdim=True) / counts
    stdev = torch.sqrt(var + eps)
    mean = torch.where(torch.isnan(mean), torch.full_like(mean, default_mean),
                       mean)
    stdev = torch.where(torch.isnan(stdev) | (stdev == 0),
                        torch.full_like(stdev, default_std), stdev)
    return RevINStats(mean, stdev)


class RevIN(nn.Module):
    def __init__(self, num_features: int, affine: bool = True,
                 eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.affine = affine
        if affine:
            self.affine_weight = nn.Parameter(torch.ones(num_features))
            self.affine_bias = nn.Parameter(torch.zeros(num_features))

    def norm(self, stats: RevINStats, x: Tensor) -> Tensor:
        x = (x - stats.mean) / stats.stdev
        if self.affine:
            x = x * self.affine_weight + self.affine_bias
        return x

    def denorm(self, stats: RevINStats, x: Tensor) -> Tensor:
        if self.affine:
            x = (x - self.affine_bias) / (self.affine_weight
                                          + self.eps * self.eps)
        return x * stats.stdev + stats.mean

    def denorm2(self, stats: RevINStats, x: Tensor) -> Tensor:
        """Statistics and affine sliced to ``x``'s trailing width."""
        k = x.shape[2]
        if self.affine:
            x = (x - self.affine_bias[:k]) / (self.affine_weight[:k]
                                              + self.eps * self.eps)
        return x * stats.stdev[:, :, :k] + stats.mean[:, :, :k]


class DishTSStats(NamedTuple):
    phil: Tensor
    phih: Tensor
    xil: Tensor
    xih: Tensor


class DishTS(nn.Module):
    """The 'standard' initialisation: ``reduce_mlayer`` 1 / prev_len,
    gamma 1, beta 0."""

    def __init__(self, stn_num: int, prev_len: int):
        super().__init__()
        self.reduce_mlayer = nn.Parameter(
            torch.ones(stn_num, prev_len, 2) / prev_len)
        self.gamma = nn.Parameter(torch.ones(stn_num))
        self.beta = nn.Parameter(torch.zeros(stn_num))

    def preget(self, x: Tensor) -> DishTSStats:
        """x (B, L, C) with L the layer's look-back."""
        theta = torch.einsum("blc,clk->bkc", x, self.reduce_mlayer)
        theta = F.gelu(theta)
        phil, phih = theta[:, :1, :], theta[:, 1:, :]
        n = x.shape[1] - 1
        xil = torch.square(x - phil).sum(dim=1, keepdim=True) / n
        xih = torch.square(x - phih).sum(dim=1, keepdim=True) / n
        return DishTSStats(phil, phih, xil, xih)

    def norm(self, x: Tensor) -> Tuple[Tensor, DishTSStats]:
        stats = self.preget(x)
        y = (x - stats.phil) / torch.sqrt(stats.xil + 1e-8)
        return y * self.gamma + self.beta, stats

    def denorm(self, stats: DishTSStats, x: Tensor) -> Tensor:
        return ((x - self.beta) / self.gamma) * torch.sqrt(stats.xih + 1e-8) \
            + stats.phih


class TimeEncode(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        alpha = int(dim ** 0.5)
        self.w = nn.Linear(1, dim)
        freqs = 1.0 / alpha ** np.linspace(0, alpha - 1, dim)
        with torch.no_grad():
            self.w.weight.copy_(torch.from_numpy(freqs).reshape(dim, 1))
            self.w.bias.zero_()

    def forward(self, t: Tensor) -> Tensor:
        """t of any shape -> (t.numel(), 2 * dim): [sin(wt + b),
        cos(wt + b)]."""
        z = t.reshape(-1, 1) @ self.w.weight.T + self.w.bias
        return torch.cat([torch.sin(z), torch.cos(z)], dim=1)
