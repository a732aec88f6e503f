"""SimVP video-prediction stack.

Counterpart of ``vit_grid_model_tpu/models/simvp.py`` (the reference's
``model.py:146-249``): an encoder of strided ConvSC layers, ``Mid_Xnet``
(an Inception U-net over the time-folded channel axis) and a decoder of
transposed ConvSC layers with a skip from the first encoder layer.  Strides
alternate 1, 2, 1, 2, ... (``stride_generator``).  The module names are the
reference's, the keys of ``core/export.py::export_simvp``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import Tensor, nn

from vit_grid_model_tpu_torch.ops.convblocks import ConvSC, Inception


def stride_generator(n: int, reverse: bool = False):
    strides = [1, 2] * 10
    return list(reversed(strides[:n])) if reverse else strides[:n]


@dataclasses.dataclass(frozen=True)
class SimVPSpec:
    shape_in: Tuple[int, int, int, int]    # (T, C, H, W)
    hid_s: int = 16
    hid_t: int = 256
    n_s: int = 4
    n_t: int = 8
    incep_ker: Tuple[int, ...] = (3, 5, 7, 11)
    groups: int = 8


class Encoder(nn.Module):
    def __init__(self, c_in: int, c_hid: int, n_s: int):
        super().__init__()
        strides = stride_generator(n_s)
        self.enc = nn.ModuleList(
            [ConvSC(c_in, c_hid, stride=strides[0])]
            + [ConvSC(c_hid, c_hid, stride=s) for s in strides[1:]])

    def forward(self, x: Tensor):
        """-> (latent, the first layer's output)."""
        enc1 = self.enc[0](x)
        latent = enc1
        for layer in self.enc[1:]:
            latent = layer(latent)
        return latent, enc1


class Decoder(nn.Module):
    def __init__(self, c_hid: int, c_out: int, n_s: int):
        super().__init__()
        strides = stride_generator(n_s, reverse=True)
        self.dec = nn.ModuleList(
            [ConvSC(c_hid, c_hid, stride=s, transpose=True)
             for s in strides[:-1]]
            + [ConvSC(2 * c_hid, c_hid, stride=strides[-1], transpose=True)])
        self.readout = nn.Conv2d(c_hid, c_out, 1)

    def forward(self, hid: Tensor, enc1: Tensor) -> Tensor:
        for layer in self.dec[:-1]:
            hid = layer(hid)
        y = self.dec[-1](torch.cat([hid, enc1], dim=1))
        return self.readout(y)


class MidXnet(nn.Module):
    def __init__(self, channel_in: int, channel_hid: int, n_t: int,
                 incep_ker=(3, 5, 7, 11), groups: int = 8):
        super().__init__()
        self.n_t = n_t
        half = channel_hid // 2
        self.enc = nn.ModuleList(
            [Inception(channel_in, half, channel_hid, incep_ker, groups)]
            + [Inception(channel_hid, half, channel_hid, incep_ker, groups)
               for _ in range(1, n_t)])
        self.dec = nn.ModuleList(
            [Inception(channel_hid, half, channel_hid, incep_ker, groups)]
            + [Inception(2 * channel_hid, half, channel_hid, incep_ker,
                         groups) for _ in range(1, n_t - 1)]
            + [Inception(2 * channel_hid, half, channel_in, incep_ker,
                         groups)])

    def forward(self, x: Tensor) -> Tensor:
        """x (B, T, C, H, W) -> the same shape; time folds into channels
        t-major."""
        b, t, c, h, w = x.shape
        z = x.reshape(b, t * c, h, w)
        skips = []
        for i, layer in enumerate(self.enc):
            z = layer(z)
            if i < self.n_t - 1:
                skips.append(z)
        z = self.dec[0](z)
        for i in range(1, self.n_t):
            z = self.dec[i](torch.cat([z, skips[-i]], dim=1))
        return z.reshape(b, t, c, h, w)


class SimVP(nn.Module):
    def __init__(self, spec: SimVPSpec):
        super().__init__()
        self.spec = spec
        t, c, _, _ = spec.shape_in
        self.enc = Encoder(c, spec.hid_s, spec.n_s)
        self.hid = MidXnet(t * spec.hid_s, spec.hid_t, spec.n_t,
                           spec.incep_ker, spec.groups)
        self.dec = Decoder(spec.hid_s, c, spec.n_s)

    def forward(self, x: Tensor) -> Tensor:
        """x (B, T, C, H, W) -> (B, T, C, H, W)."""
        b, t, c, h, w = x.shape
        embed, skip = self.enc(x.reshape(b * t, c, h, w))
        _, hc, hh, ww = embed.shape
        hid = self.hid(embed.reshape(b, t, hc, hh, ww))
        y = self.dec(hid.reshape(b * t, hc, hh, ww), skip)
        return y.reshape(b, t, c, h, w)
