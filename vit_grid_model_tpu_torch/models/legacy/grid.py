"""Legacy grid models: a station LSTM and a grid LSTM with a joint
(grid ++ station) attention over every grid cell.

Counterpart of ``vit_grid_model_tpu/models/legacy/grid.py`` (the
reference's ``simulation_grid_model`` v1-v3, ``model.py:865-1499``).
``GridModel(spec, lats, lons, cmaq_coords)`` builds each version of
``GridModelSpec``; its state_dict keys are those of
``core/export.py::export_grid_model``, and the coordinates are
non-persistent buffers.  Details kept from the JAX package:

* v1 runs the grid LSTM (``grid_decoder_lstm``) in the decode phase only,
  with its grid time features from the output window but the CMAQ blocks
  read at step ``i``, the input window's; in its encode phase the stations
  attend to one another through ``mha_e``;
* v2 and v3 run the grid LSTM (``grid_lstm``) through the encode phase as
  well.  ``mha_e`` stays in their state_dict, but the reference discards
  its encode-phase output, so it is not computed;
* the joint attention over (grid ++ station) tokens, the grid tokens always
  valid, feeds only the output head: it is never written back to the
  recurrent states;
* station PM is always standardised; v3 normalises the input window's PM
  cycle channels against the grid history by RevIN, DishTS or Standard
  and denormalises the output the same way, DishTS with the statistics of
  the last of its four cycle calls; the other versions de-standardise.

A forward opens the spans (``utils/profiling.py::annotate``)
``grid.forward`` > ``grid.input`` (location and time features, PM
standardisation, v3's normalisation), ``grid.encode`` and ``grid.decode``;
inside the last two ``grid.lstm`` around each LSTM cell step and
``grid.step_input`` around each grid step's input, and inside
``grid.decode`` also ``grid.joint_attn`` and ``grid.head`` (``last_fc``,
the denormalisation and ReLU).  Every kernel of a forward is launched in
one of them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from vit_grid_model_tpu_torch.models.legacy.station import (
    TIME_ENCODERS, coordinate_buffer, location_features, time_features)
from vit_grid_model_tpu_torch.models.normalizers import (DishTS, RevIN,
                                                         TimeEncode,
                                                         revin_statistics)
from vit_grid_model_tpu_torch.ops.recurrent import (lstm_cell,
                                                    mha_self_attention,
                                                    residual_masked_attention)
from vit_grid_model_tpu_torch.utils.profiling import annotate

PM_CYCLE_OFFSETS = (4, 10, 16, 22)
# the same channels as one strided view: indexing by a list of offsets
# copies the list to the device and waits for the device at each use
PM_CYCLES = slice(4, 23, 6)


@dataclasses.dataclass(frozen=True)
class GridModelSpec:
    input_dim: int = 7
    feat_dim: int = 12
    hidden_dim: int = 128
    pm25_mean: float = 0.0
    pm25_std: float = 1.0
    output_dim: int = 6
    prev_len: int = 100
    korea_stn_num: int = 0
    china_stn_num: int = 0
    grid_shape: Tuple[int, int] = (82, 67)
    normalization_method: str = "Standard"
    version: int = 3          # 1 | 2 | 3

    @property
    def total_stn_num(self) -> int:
        return self.korea_stn_num + self.china_stn_num

    @property
    def cells(self) -> int:
        return self.grid_shape[0] * self.grid_shape[1]

    @property
    def enc_dim(self) -> int:
        return self.hidden_dim // 32

    @property
    def block_channels(self) -> int:
        return (self.feat_dim // 2) * 4 + 4


def joint_attention(mha: nn.MultiheadAttention, grid_h: Tensor,
                    stn_h: Tensor, stn_valid: Tensor) -> Tensor:
    """``tokens + attention(tokens)`` over (grid ++ station) tokens, the
    grid tokens always valid as keys."""
    b, g = grid_h.shape[:2]
    tokens = torch.cat([grid_h, stn_h], dim=1)
    valid = torch.cat([torch.ones(b, g, dtype=torch.bool,
                                  device=stn_valid.device),
                       stn_valid.bool()], dim=1)
    return tokens + mha_self_attention(mha, tokens, key_padding_mask=~valid)


class GridModel(nn.Module):
    def __init__(self, spec: GridModelSpec, lats, lons, cmaq_coords):
        super().__init__()
        self.spec = spec
        h = spec.hidden_dim
        h16 = h // 16
        coordinate_buffer(self, "lats", lats)
        coordinate_buffer(self, "lons", lons)
        coordinate_buffer(self, "cmaq_coords", cmaq_coords)
        for name in TIME_ENCODERS + ("simulation_hour_encoder",):
            setattr(self, name, TimeEncode(spec.enc_dim))
        self.station_encoder_lstm = nn.LSTMCell(spec.feat_dim + h16 * 5, h)
        self.station_decoder_lstm = nn.LSTMCell(h16 * 5, h)
        # time (3 h16) + CMAQ values (2 feat_dim) + lead hours (4 h16)
        # + location (2 h16)
        grid_lstm = nn.LSTMCell(spec.feat_dim * 2 + h16 * 9, h)
        setattr(self, self.grid_lstm_name, grid_lstm)
        self.mha_e = nn.MultiheadAttention(h, 1)
        self.mha_d = nn.MultiheadAttention(h, 1)
        self.last_fc = nn.Linear(h, 1)
        stn, cells = spec.total_stn_num, spec.cells
        self.station_hidden_init = nn.Parameter(torch.zeros(stn, h))
        self.station_cell_init = nn.Parameter(torch.zeros(stn, h))
        self.grid_hidden_init = nn.Parameter(torch.zeros(cells, h))
        self.grid_cell_init = nn.Parameter(torch.zeros(cells, h))
        if spec.version == 3:
            if spec.normalization_method == "RevIN":
                self.revin_layer = RevIN(cells)
            if spec.normalization_method == "DishTS":
                self.dishts_layer = DishTS(cells, spec.prev_len)

    @property
    def grid_lstm_name(self) -> str:
        return "grid_decoder_lstm" if self.spec.version == 1 else "grid_lstm"

    def _grid_step_input(self, simulation: Tensor, step: int,
                         grid_time: Tensor, grid_loc: Tensor,
                         standardize_pm: bool) -> Tensor:
        """The grid LSTM's input at one absolute step of the stacked CMAQ
        tensor (``model.py:1010-1024``)."""
        spec = self.spec
        b, cells, bc = simulation.shape[0], spec.cells, spec.block_channels
        s4 = (spec.feat_dim // 2) * 4
        blk = simulation[..., step * bc:(step + 1) * bc]
        sim_vals = blk[..., :s4].reshape(b, cells, s4)
        lead = blk[..., s4:].reshape(b, cells, 4)
        lead_enc = self.simulation_hour_encoder(lead).reshape(b, cells, -1)
        if standardize_pm:
            sim_vals = sim_vals.clone()
            pm = sim_vals[:, :, PM_CYCLES]
            pm.copy_((pm - spec.pm25_mean) / spec.pm25_std)
        return torch.cat([grid_time, sim_vals.reshape(b * cells, -1),
                          lead_enc.reshape(b * cells, -1), grid_loc], dim=-1)

    def _normalize_cycles(self, simulation: Tensor, prev_vals: Tensor):
        """v3: the input window's PM cycle channels normalised against the
        grid history; returns (simulation, statistics)."""
        spec = self.spec
        b, cells, bc = simulation.shape[0], spec.cells, spec.block_channels
        # (B, T_in, cells) per cycle
        pm_steps = [torch.stack([simulation[..., i * bc + off].reshape(
            b, cells) for i in range(spec.input_dim)], dim=1)
            for off in PM_CYCLE_OFFSETS]
        stats = None
        method = spec.normalization_method
        if method == "RevIN":
            stats = revin_statistics(
                prev_vals.reshape(b, spec.prev_len, cells),
                default_mean=spec.pm25_mean, default_std=spec.pm25_std)
            pm_steps = [self.revin_layer.norm(stats, x) for x in pm_steps]
        elif method == "DishTS":
            normed = []
            for x in pm_steps:
                y, stats = self.dishts_layer.norm(x)   # the last call's
                normed.append(y)
            pm_steps = normed
        else:
            pm_steps = [(x - spec.pm25_mean) / spec.pm25_std
                        for x in pm_steps]
        simulation = simulation.clone()
        for i in range(spec.input_dim):
            for ci, off in enumerate(PM_CYCLE_OFFSETS):
                simulation[..., i * bc + off] = pm_steps[ci][:, i].reshape(
                    b, *spec.grid_shape)
        return simulation, stats

    def forward(self, feats: Tensor, masks: Tensor, raw_times: Tensor,
                prev_vals: Tensor, simulation: Tensor) -> Tensor:
        """feats (B, T_in, stn, F); masks (B, T_in + T_out, stn) bool;
        raw_times (B, T_in + T_out, 3) month/day/hour; prev_vals
        (B, prev_len, H, W) grid history (read by v3 only); simulation
        (B, H, W, (T_in + T_out) * block_channels).  Returns
        (B, cells, output_dim)."""
        spec = self.spec
        b = feats.shape[0]
        h_dim, stn, cells = spec.hidden_dim, spec.total_stn_num, spec.cells
        grid_lstm = getattr(self, self.grid_lstm_name)
        with annotate("grid.forward"):
            with annotate("grid.input"):
                stn_loc = location_features(self, self.lats, self.lons, b)
                grid_loc = location_features(self, self.cmaq_coords[..., 0],
                                             self.cmaq_coords[..., 1], b)
                time_feat = time_features(self, raw_times, stn)
                # v1 takes the grid time features from the output window
                # only
                time_feat_grid = time_features(
                    self, raw_times[:, spec.input_dim:] if spec.version == 1
                    else raw_times, cells)
                feats = torch.cat(
                    [(feats[..., :1] - spec.pm25_mean) / spec.pm25_std,
                     feats[..., 1:]], dim=-1)
                norm_stats = None
                if spec.version == 3:
                    simulation, norm_stats = self._normalize_cycles(
                        simulation, prev_vals)

            with annotate("grid.encode"):
                stn_h = self.station_hidden_init.expand(b, stn, h_dim)
                stn_c = self.station_cell_init.expand(b, stn, h_dim).reshape(
                    b * stn, h_dim)
                grid_h = self.grid_hidden_init.expand(b, cells, h_dim)
                grid_c = self.grid_cell_init.expand(b, cells, h_dim).reshape(
                    b * cells, h_dim)
                for i in range(spec.input_dim):
                    inp = torch.cat([feats[:, i].reshape(b * stn, -1),
                                     time_feat[i], stn_loc], dim=-1)
                    with annotate("grid.lstm"):
                        h_new, stn_c = lstm_cell(
                            self.station_encoder_lstm, inp,
                            stn_h.reshape(b * stn, h_dim), stn_c)
                    stn_h = h_new.reshape(b, stn, h_dim)
                    if spec.version == 1:
                        stn_h = residual_masked_attention(self.mha_e, stn_h,
                                                          masks[:, i])
                        continue
                    with annotate("grid.step_input"):
                        ginp = self._grid_step_input(
                            simulation, i, time_feat_grid[i], grid_loc,
                            standardize_pm=spec.version == 2)
                    with annotate("grid.lstm"):
                        g_new, grid_c = lstm_cell(
                            grid_lstm, ginp, grid_h.reshape(b * cells, h_dim),
                            grid_c)
                    grid_h = g_new.reshape(b, cells, h_dim)

            with annotate("grid.decode"):
                preds = []
                for i in range(spec.output_dim):
                    sinp = torch.cat([time_feat[i + spec.input_dim],
                                      stn_loc], dim=-1)
                    with annotate("grid.lstm"):
                        h_new, stn_c = lstm_cell(
                            self.station_decoder_lstm, sinp,
                            stn_h.reshape(b * stn, h_dim), stn_c)
                    stn_h = h_new.reshape(b, stn, h_dim)
                    if spec.version == 1:
                        # the output window's time features, the input
                        # window's CMAQ block
                        tfg, sim_step = time_feat_grid[i], i
                    else:
                        tfg, sim_step = (time_feat_grid[i + spec.input_dim],
                                         i + spec.input_dim)
                    with annotate("grid.step_input"):
                        ginp = self._grid_step_input(
                            simulation, sim_step, tfg, grid_loc,
                            standardize_pm=True)
                    with annotate("grid.lstm"):
                        g_new, grid_c = lstm_cell(
                            grid_lstm, ginp, grid_h.reshape(b * cells, h_dim),
                            grid_c)
                    grid_h = g_new.reshape(b, cells, h_dim)

                    with annotate("grid.joint_attn"):
                        attended = joint_attention(
                            self.mha_d, grid_h, stn_h,
                            masks[:, spec.input_dim + i])
                    with annotate("grid.head"):
                        result = self.last_fc(attended[:, :cells])
                        method = spec.normalization_method
                        if spec.version == 3 and method == "RevIN":
                            result = self.revin_layer.denorm(
                                norm_stats, result.transpose(1, 2)
                            ).transpose(1, 2)
                        elif spec.version == 3 and method == "DishTS":
                            result = self.dishts_layer.denorm(
                                norm_stats, result.transpose(1, 2)
                            ).transpose(1, 2)
                        else:
                            result = result * spec.pm25_std + spec.pm25_mean
                        preds.append(F.relu(result))   # (B, cells, 1)
                return torch.cat(preds, dim=-1)
