"""Weights, coordinates and inputs of the station-to-grid LSTM drawn from a
run's seed, on the device, in a few large calls: the same seed gives the
same tensors on the same device.

Weights follow ``gridbench/reference/grid.py``'s parameter table: uniform
weights and biases within 1 / sqrt(fan-in) (the LSTM cells' own bound, 1 /
sqrt(hidden)), initial states and shifts 0.1 N, gains 1 + 0.1 N, DishTS's
reduction (1 + 0.1 N) / prev_len.  Station coordinates are uniform over
33-38 N, 125-130 E; the grid's a regular mesh over 32-39.5 N, 123-132 E.

Inputs are a ring of ``ring`` batches, every PM2.5 value raw (mean + std
N(0, 1), at least 0) and every other species standardized N(0, 1):

* ``feats`` (ring, B, T_in, stations, F): PM2.5 first;
* ``masks`` (ring, B, T_in + T_out, stations) bool: a station-step
  reports with probability 1 - ``masked``;
* ``raw_times`` (ring, B, T_in + T_out, 3): month, day (1-28) and hour of
  consecutive hours from a start drawn for each sample;
* ``prev_vals`` (ring, B, prev_len, H, W): the grid's PM2.5 history;
* ``simulation`` (ring, B, H, W, (T_in + T_out) * 28): each step's CMAQ
  block, the four cycles' six species with PM2.5 at offsets 4, 10, 16, 22,
  then the cycles' lead hours (the step plus 0, 6, 12 and 18 h from a start
  in 0-5 drawn for each sample), the same over the grid.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import Tensor

from gridbench.common.seeded import generator
from gridbench.reference import grid as G


def weights(cfg: dict, seed: int, device) -> Dict[str, Tensor]:
    """The f32 state dict of the reference's table, drawn from ``seed``."""
    table = G.param_table(cfg)
    total = sum(int(torch.Size(shape).numel()) for shape, _, _ in
                table.values())
    g = generator(seed, 11, device)
    uni = torch.rand(total, generator=g, device=device)
    nrm = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, (shape, kind, fan) in table.items():
        k = int(torch.Size(shape).numel())
        u, z = uni[at:at + k].view(shape), nrm[at:at + k].view(shape)
        at += k
        if kind in ("weight", "bias"):
            t = (2.0 * u - 1.0) / fan ** 0.5
        elif kind in ("state", "shift"):
            t = 0.1 * z
        elif kind == "gain":
            t = 1.0 + 0.1 * z
        elif kind == "reduce":
            t = (1.0 + 0.1 * z) / fan
        else:
            raise ValueError(f"{name}: unknown kind {kind!r}")
        out[name] = t.clone()
    return out


def coords(cfg: dict, seed: int, device) -> Dict[str, Tensor]:
    """{'lats', 'lons': (stations,), 'cmaq_coords': (H, W, 2) lat, lon}."""
    stn = G.sizes(cfg)["stations"]
    H, W = cfg["grid_shape"]
    g = generator(seed, 12, device)
    lat = torch.linspace(32.0, 39.5, H, device=device)
    lon = torch.linspace(123.0, 132.0, W, device=device)
    mesh = torch.stack(torch.meshgrid(lat, lon, indexing="ij"), dim=-1)
    return {"lats": 33.0 + 5.0 * torch.rand(stn, generator=g, device=device),
            "lons": 125.0 + 5.0 * torch.rand(stn, generator=g, device=device),
            "cmaq_coords": mesh}


def _pm(cfg: dict, z: Tensor) -> Tensor:
    return (cfg["pm25_mean"] + cfg["pm25_std"] * z).clamp_min(0.0)


def batches(cfg: dict, seed: int, ring: int, batch: int, device,
            masked: float) -> Dict[str, Tensor]:
    """The ring of inputs that the module docstring lists."""
    z = G.sizes(cfg)
    g = generator(seed, 13, device)
    t_in, steps = cfg["input_dim"], cfg["input_dim"] + cfg["output_dim"]
    stn, H, W = z["stations"], *cfg["grid_shape"]
    lead = (ring, batch)
    feats = torch.randn(lead + (t_in, stn, cfg["feat_dim"]), generator=g,
                        device=device)
    feats[..., 0] = _pm(cfg, feats[..., 0])
    masks = torch.rand(lead + (steps, stn), generator=g,
                       device=device) >= masked
    month = torch.randint(1, 13, lead, generator=g, device=device)
    day = torch.randint(1, 29, lead, generator=g, device=device)
    hour = torch.randint(0, 24, lead, generator=g, device=device)
    hours = hour[..., None] + torch.arange(steps, device=device)
    raw_times = torch.stack([month[..., None].expand_as(hours),
                             day[..., None] + hours // 24, hours % 24],
                            dim=-1).float()
    prev_vals = _pm(cfg, torch.randn(lead + (cfg["prev_len"], H, W),
                                     generator=g, device=device))
    sim = torch.randn(lead + (H, W, steps, z["block"]), generator=g,
                      device=device)
    pm = list(G.PM_OFFSETS)
    sim[..., pm] = _pm(cfg, sim[..., pm])
    start = torch.randint(0, 6, lead, generator=g, device=device)
    cycles = torch.arange(0, 24, 6, device=device)
    leads = (start[..., None, None] + torch.arange(steps, device=device)
             [:, None] + cycles).float()             # (ring, B, steps, 4)
    sim[..., z["values"]:] = leads[:, :, None, None]
    return {"feats": feats, "masks": masks, "raw_times": raw_times,
            "prev_vals": prev_vals,
            "simulation": sim.view(lead + (H, W, steps * z["block"]))}
