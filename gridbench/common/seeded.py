"""Weights and inputs drawn from a run's seed, on the device, in a few
large calls: the same seed gives the same tensors on the same device.

Weights follow the reference's parameter table: fan-in uniform weights and
biases, standard-normal embeddings, tables and register tokens, norm gains
1 + 0.1 N and shifts 0.1 N, running means 0.1 N and variances U(0.5, 1.5).
Inputs are a ring of ``ring`` batches: standardized species N(0, 1), the
four PM2.5 cycle channels raw (mean + std N(0, 1)), timestamps of 2023
with a month, a day (1-28) and an hour for every row, and, for training,
targets mean + std N(0, 1) with a tenth of the cells NaN (missing).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import Tensor

from gridbench.reference import metnet3 as M

_MASK = 2 ** 63 - 1


def sub_seed(seed: int, stream: int) -> int:
    """A seed of its own for each stream drawn from a run's seed."""
    return (seed * 1_000_003 + stream * 7_919) & _MASK


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


def weights(cfg: dict, seed: int, device) -> Dict[str, Tensor]:
    """The f32 state dict of the reference's table, drawn from ``seed``."""
    table = M.param_table(cfg)
    total = sum(int(torch.Size(shape).numel()) for shape, _, _ in
                table.values())
    g = generator(seed, 1, device)
    uni = torch.rand(total, generator=g, device=device)
    nrm = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, (shape, kind, fan) in table.items():
        k = int(torch.Size(shape).numel())
        u, z = uni[at:at + k].view(shape), nrm[at:at + k].view(shape)
        at += k
        if kind in ("weight", "bias"):
            t = (2.0 * u - 1.0) / fan ** 0.5
        elif kind == "embedding":
            t = z
        elif kind == "gain":
            t = 1.0 + 0.1 * z
        elif kind in ("shift", "running_mean"):
            t = 0.1 * z
        elif kind == "running_var":
            t = 0.5 + u
        elif kind == "count":
            t = torch.zeros(shape, dtype=torch.int64, device=device)
        elif kind == "boundaries":
            t = torch.tensor(cfg["pm25_boundaries"], device=device)
        else:
            raise ValueError(f"{name}: unknown kind {kind!r}")
        out[name] = t.clone()
    return out


def batches(cfg: dict, seed: int, ring: int, batch: int, device, *,
            targets: bool = False) -> Dict[str, Tensor]:
    """{'x': (ring, B, T, C, H, W) f32, 'timestamps': (ring, B, T, 4) f32,
    and with ``targets`` 'targets': (ring, B, L, H, W) f32}."""
    g = generator(seed, 2, device)
    T, C = cfg["window_size"], cfg["n_variables"]
    H, W = cfg["input_height"], cfg["input_width"]
    x = torch.randn((ring, batch, T, C, H, W), generator=g, device=device)
    pm = list(cfg["pm25_channel_indices"])
    x[:, :, :, pm] = cfg["pm25_mean"] + cfg["pm25_std"] * x[:, :, :, pm]
    shape = (ring, batch, T)
    month = torch.randint(1, 13, shape, generator=g, device=device)
    day = torch.randint(1, 29, shape, generator=g, device=device)
    hour = torch.randint(0, 24, shape, generator=g, device=device)
    ts = torch.stack([torch.full_like(month, 2023), month, day, hour],
                     dim=-1).float()
    out = {"x": x, "timestamps": ts}
    if targets:
        L = cfg["end_lead_time"]
        y = torch.randn((ring, batch, L, H, W), generator=g, device=device)
        y = cfg["pm25_mean"] + cfg["pm25_std"] * y
        missing = torch.rand(y.shape, generator=g, device=device) < 0.1
        out["targets"] = torch.where(missing, torch.full_like(y, float("nan")),
                                     y)
    return out


def nhwc(x: Tensor, multiple: int, dtype: torch.dtype) -> Tensor:
    """(..., T, C, H, W) -> (..., Hp, Wp, T*C): the planes zero-padded,
    centered, to ``multiple`` and moved channels-last, in ``dtype``."""
    lead = x.shape[:-4]
    T, C, H, W = x.shape[-4:]
    left, right, top, bottom = M.pad_values(H, W, multiple)
    planes = torch.nn.functional.pad(x.reshape(-1, T * C, H, W),
                                     (left, right, top, bottom))
    return (planes.permute(0, 2, 3, 1).to(dtype).contiguous()
            .view(*lead, H + top + bottom, W + left + right, T * C))
