"""The plain reference of the station-to-grid LSTM
(``simulation_grid_model_v3``, github.com/jhsk777/VIT-Grid-Model
``src/model.py:1250-1500``): float32 PyTorch, written from the published
computation, with no kernel, no fusion and no import of the program under
test.

The parameters are a flat dict keyed by the published model's state_dict
names (``param_table``); the station and grid coordinates, which the
published model keeps as plain attributes, come apart (``lats``, ``lons``
(stations,) and ``cmaq_coords`` (H, W, 2)).  The computation, in order:

* each point's location is [lat, lon] through two time encoders
  (``[sin(w t + b), cos(w t + b)]``), each step's time [month, day, hour]
  through three, repeated over the stations or the grid cells;
* station PM2.5 (feature 0) is standardized with the global mean and std;
* the PM2.5 cycle channels (offsets 4, 10, 16, 22 of each step's 28) of the
  input window are normalized against the grid history ``prev_vals`` by
  the configured method: RevIN (per cell and sample, the history's mean
  and biased std, NaN-aware with the global statistics as the fallback,
  then the per-cell affine), DishTS (per cycle, the statistics of the last
  cycle kept for the output) or Standard; the output window's are
  standardized;
* the input window: a station LSTM cell step and a grid LSTM cell step a
  step (the grid LSTM runs through the input window too), the grid's input
  [time, the 24 CMAQ values, the 4 lead hours encoded, location];
* the output window: a station LSTM step over [time, location], a grid
  LSTM step over the step's CMAQ block, then one single-head attention
  over the grid tokens followed by the station tokens, the station keys
  masked where ``masks`` is false, with the residual; the grid tokens of
  its result go through ``last_fc``, the method's denormalization and a
  ReLU.  The attention feeds only the output: the recurrent states go on
  from the LSTMs' own.

Departures, neither of which changes the result:

* the input window's station attention ``mha_e``, whose output the
  published model discards, is not computed (its weights stay in the
  table);
* the attention's softmax is a plain masked softmax: the grid keys are
  always valid, so no row is fully masked.  It runs over blocks of
  ``block`` query rows so that a full-size batch fits beside the
  benchmark's ring.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

Params = Dict[str, Tensor]
Table = Dict[str, Tuple[Tuple[int, ...], str, int]]

#: channel offsets of the four PM2.5 cycles within a step's CMAQ block
PM_OFFSETS = (4, 10, 16, 22)
#: query rows of the attention computed at once
QUERY_BLOCK = 1024
_TIME = ("month_encoder", "day_encoder", "hour_encoder")
_ENCODERS = ("lat_encoder", "lon_encoder") + _TIME + (
    "simulation_hour_encoder",)


def sizes(cfg: dict) -> dict:
    """The derived widths: stations, cells, hidden/16, the time encoders'
    width, the CMAQ block's channels and the values among them."""
    h = cfg["hidden_dim"]
    s4 = (cfg["feat_dim"] // 2) * 4
    H, W = cfg["grid_shape"]
    return dict(stations=cfg["korea_stn_num"] + cfg["china_stn_num"],
                cells=H * W, h16=h // 16, enc=h // 32, values=s4,
                block=s4 + 4)


def param_table(cfg: dict) -> Table:
    """{name: (shape, kind, fan-in)} in the state_dict's order."""
    z = sizes(cfg)
    h, stn, cells, h16 = cfg["hidden_dim"], z["stations"], z["cells"], z["h16"]
    t = OrderedDict()
    for name in ("station_hidden_init", "station_cell_init"):
        t[name] = ((stn, h), "state", 1)
    for name in ("grid_hidden_init", "grid_cell_init"):
        t[name] = ((cells, h), "state", 1)
    for enc in _ENCODERS:
        t[f"{enc}.w.weight"] = ((z["enc"], 1), "weight", 1)
        t[f"{enc}.w.bias"] = ((z["enc"],), "bias", 1)
    for name, n_in in (("station_encoder_lstm", cfg["feat_dim"] + 5 * h16),
                       ("station_decoder_lstm", 5 * h16),
                       ("grid_lstm", 2 * cfg["feat_dim"] + 9 * h16)):
        # the LSTM cell's own initialisation bound, 1 / sqrt(hidden)
        t[f"{name}.weight_ih"] = ((4 * h, n_in), "weight", h)
        t[f"{name}.weight_hh"] = ((4 * h, h), "weight", h)
        t[f"{name}.bias_ih"] = ((4 * h,), "bias", h)
        t[f"{name}.bias_hh"] = ((4 * h,), "bias", h)
    for name in ("mha_e", "mha_d"):
        t[f"{name}.in_proj_weight"] = ((3 * h, h), "weight", h)
        t[f"{name}.in_proj_bias"] = ((3 * h,), "bias", h)
        t[f"{name}.out_proj.weight"] = ((h, h), "weight", h)
        t[f"{name}.out_proj.bias"] = ((h,), "bias", h)
    t["last_fc.weight"] = ((1, h), "weight", h)
    t["last_fc.bias"] = ((1,), "bias", h)
    method = cfg["normalization_method"]
    if method == "RevIN":
        t["revin_layer.affine_weight"] = ((cells,), "gain", 1)
        t["revin_layer.affine_bias"] = ((cells,), "shift", 1)
    elif method == "DishTS":
        t["dishts_layer.reduce_mlayer"] = ((cells, cfg["prev_len"], 2),
                                           "reduce", cfg["prev_len"])
        t["dishts_layer.gamma"] = ((cells,), "gain", 1)
        t["dishts_layer.beta"] = ((cells,), "shift", 1)
    return t


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------


def _encode(P: Params, name: str, t: Tensor) -> Tensor:
    """t (...) -> (..., 2 * width): [sin(w t + b), cos(w t + b)]."""
    z = t.reshape(-1, 1) @ P[f"{name}.w.weight"].T + P[f"{name}.w.bias"]
    return torch.cat([z.sin(), z.cos()], dim=-1).reshape(*t.shape, -1)


def _lstm(P: Params, name: str, x: Tensor, h: Tensor,
          c: Tensor) -> Tuple[Tensor, Tensor]:
    """One LSTM cell step, gates in the order input, forget, cell, output."""
    gates = (F.linear(x, P[f"{name}.weight_ih"], P[f"{name}.bias_ih"])
             + F.linear(h, P[f"{name}.weight_hh"], P[f"{name}.bias_hh"]))
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def attention(P: Params, name: str, tokens: Tensor, valid: Tensor,
              block: int = QUERY_BLOCK) -> Tensor:
    """``tokens + attention(tokens)``: one head over tokens (B, n, E), the
    keys where ``valid`` (B, n) is false masked, the queries in blocks of
    ``block`` rows."""
    e = tokens.shape[-1]
    q, k, v = F.linear(tokens, P[f"{name}.in_proj_weight"],
                       P[f"{name}.in_proj_bias"]).chunk(3, dim=-1)
    q = q * (1.0 / math.sqrt(e))
    keys = k.transpose(1, 2)
    masked = ~valid[:, None, :]
    out = torch.empty_like(q)
    for s in range(0, tokens.shape[1], block):
        scores = (q[:, s:s + block] @ keys).masked_fill(masked, -math.inf)
        out[:, s:s + block] = scores.softmax(dim=-1) @ v
    return tokens + F.linear(out, P[f"{name}.out_proj.weight"],
                             P[f"{name}.out_proj.bias"])


def _revin_stats(history: Tensor, mean0: float, std0: float,
                 eps: float = 1e-5) -> Tuple[Tensor, Tensor]:
    """history (B, L, cells) -> mean, std (B, cells): the mean over the
    hours (NaN if one is NaN) and the biased std over the hours that are
    not; the global statistics where either is NaN or the std is 0."""
    seen = ~torch.isnan(history)
    mean = history.mean(dim=1)
    dev = torch.where(seen, history - mean[:, None], torch.zeros_like(history))
    std = (dev.square().sum(dim=1) / seen.sum(dim=1) + eps).sqrt()
    mean = torch.where(torch.isnan(mean), torch.full_like(mean, mean0), mean)
    std = torch.where(torch.isnan(std) | (std == 0),
                      torch.full_like(std, std0), std)
    return mean, std


def _dishts(P: Params, x: Tensor):
    """x (B, cells, L) -> (normalized x, (phi_h, xi_h) (B, cells) of the
    output's denormalization)."""
    theta = F.gelu(torch.einsum("bcl,clk->bck", x,
                                P["dishts_layer.reduce_mlayer"]))
    phi_l, phi_h = theta[..., 0], theta[..., 1]
    n = x.shape[-1] - 1
    xi_l = (x - phi_l[..., None]).square().sum(dim=-1) / n
    xi_h = (x - phi_h[..., None]).square().sum(dim=-1) / n
    y = (x - phi_l[..., None]) / (xi_l[..., None] + 1e-8).sqrt()
    y = y * P["dishts_layer.gamma"][:, None] + P["dishts_layer.beta"][:, None]
    return y, (phi_h, xi_h)


def _normalized_blocks(P: Params, cfg: dict, simulation: Tensor,
                       prev_vals: Tensor):
    """simulation (B, H, W, steps * block) -> (B, cells, steps, block) with
    the input window's PM cycles normalized against the history and the
    output window's standardized, and the statistics of the output."""
    z = sizes(cfg)
    b, t_in = simulation.shape[0], cfg["input_dim"]
    mean0, std0 = cfg["pm25_mean"], cfg["pm25_std"]
    blocks = simulation.reshape(b, z["cells"], -1, z["block"]).clone()
    pm = list(PM_OFFSETS)
    past = blocks[:, :, :t_in][..., pm]                 # (B, cells, T_in, 4)
    method = cfg["normalization_method"]
    if method == "RevIN":
        mean, std = _revin_stats(prev_vals.reshape(b, -1, z["cells"]),
                                 mean0, std0)
        past = (past - mean[..., None, None]) / std[..., None, None]
        past = (past * P["revin_layer.affine_weight"][:, None, None]
                + P["revin_layer.affine_bias"][:, None, None])
        stats = (mean, std)
    elif method == "DishTS":
        cycles = []
        for ci in range(len(pm)):
            y, stats = _dishts(P, past[..., ci])
            cycles.append(y)
        past = torch.stack(cycles, dim=-1)
    else:
        past = (past - mean0) / std0
        stats = None
    blocks[:, :, :t_in, pm] = past
    blocks[:, :, t_in:, pm] = (blocks[:, :, t_in:, pm] - mean0) / std0
    return blocks, stats


def _denormalize(P: Params, cfg: dict, y: Tensor, stats) -> Tensor:
    """y (B, cells) of ``last_fc`` -> the field in the data's units."""
    method = cfg["normalization_method"]
    if method == "RevIN":
        mean, std = stats
        y = ((y - P["revin_layer.affine_bias"])
             / (P["revin_layer.affine_weight"] + 1e-10))
        return y * std + mean
    if method == "DishTS":
        phi_h, xi_h = stats
        y = (y - P["dishts_layer.beta"]) / P["dishts_layer.gamma"]
        return y * (xi_h + 1e-8).sqrt() + phi_h
    return y * cfg["pm25_std"] + cfg["pm25_mean"]


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------


def forward(P: Params, cfg: dict, coords: Dict[str, Tensor], feats: Tensor,
            masks: Tensor, raw_times: Tensor, prev_vals: Tensor,
            simulation: Tensor, *, block: int = QUERY_BLOCK) -> Tensor:
    """feats (B, T_in, stations, F); masks (B, T_in + T_out, stations) bool,
    true where a station reports; raw_times (B, T_in + T_out, 3) month, day,
    hour; prev_vals (B, prev_len, H, W); simulation (B, H, W,
    (T_in + T_out) * block).  Returns (B, cells, T_out)."""
    z = sizes(cfg)
    b = feats.shape[0]
    stn, cells, h = z["stations"], z["cells"], cfg["hidden_dim"]
    t_in, t_out = cfg["input_dim"], cfg["output_dim"]

    def place(lat: Tensor, lon: Tensor) -> Tensor:
        enc = torch.cat([_encode(P, "lat_encoder", lat),
                         _encode(P, "lon_encoder", lon)], dim=-1)
        return enc.reshape(-1, enc.shape[-1]).repeat(b, 1)

    stn_place = place(coords["lats"], coords["lons"])
    grid_place = place(coords["cmaq_coords"][..., 0],
                       coords["cmaq_coords"][..., 1])
    when = torch.cat([_encode(P, enc, raw_times[..., i])
                      for i, enc in enumerate(_TIME)], dim=-1)

    def at(step: int, points: int) -> Tensor:
        """The step's time features, one row a (sample, point)."""
        return when[:, step, None, :].expand(b, points, -1).reshape(
            b * points, -1)

    pm = torch.cat([(feats[..., :1] - cfg["pm25_mean"]) / cfg["pm25_std"],
                    feats[..., 1:]], dim=-1)
    blocks, stats = _normalized_blocks(P, cfg, simulation, prev_vals)

    def grid_input(step: int) -> Tensor:
        blk = blocks[:, :, step]
        lead = _encode(P, "simulation_hour_encoder", blk[..., z["values"]:])
        return torch.cat([at(step, cells),
                          blk[..., :z["values"]].reshape(b * cells, -1),
                          lead.reshape(b * cells, -1), grid_place], dim=-1)

    stn_h, stn_c, grid_h, grid_c = (
        P[name].repeat(b, 1) for name in (
            "station_hidden_init", "station_cell_init", "grid_hidden_init",
            "grid_cell_init"))
    for step in range(t_in):
        x = torch.cat([pm[:, step].reshape(b * stn, -1), at(step, stn),
                       stn_place], dim=-1)
        stn_h, stn_c = _lstm(P, "station_encoder_lstm", x, stn_h, stn_c)
        grid_h, grid_c = _lstm(P, "grid_lstm", grid_input(step), grid_h,
                               grid_c)

    out = []
    for i in range(t_out):
        step = t_in + i
        stn_h, stn_c = _lstm(P, "station_decoder_lstm",
                             torch.cat([at(step, stn), stn_place], dim=-1),
                             stn_h, stn_c)
        grid_h, grid_c = _lstm(P, "grid_lstm", grid_input(step), grid_h,
                               grid_c)
        tokens = torch.cat([grid_h.reshape(b, cells, h),
                            stn_h.reshape(b, stn, h)], dim=1)
        valid = torch.cat([torch.ones(b, cells, dtype=torch.bool,
                                      device=masks.device),
                           masks[:, step].bool()], dim=1)
        joint = attention(P, "mha_d", tokens, valid, block)
        y = F.linear(joint[:, :cells], P["last_fc.weight"],
                     P["last_fc.bias"])[..., 0]
        out.append(F.relu(_denormalize(P, cfg, y, stats)))
    return torch.stack(out, dim=-1)
