"""Legacy station-level models: MultiAir and the simulation_model family.

Counterpart of ``vit_grid_model_tpu/models/legacy/station.py`` (the
reference's ``model.py:251-863``): an LSTM encoder over station time series
with a masked attention across stations at every step, then a decoder fed
satellite, CMAQ-cycle or no inputs.  ``StationModel(spec, lats, lons)``
builds every variant of ``StationModelSpec``; its state_dict keys are those
of ``core/export.py::export_station_model``, and ``lats``/``lons`` are
non-persistent buffers (plain attributes in the reference).  Details kept
from the JAX package:

* ``raw_times`` columns are (month, day, hour);
* MultiAir: the satellite statistics use the ``ddof=1`` std, and ``-1`` in
  ``sat_inputs`` reads as 0; RevIN, DishTS or Standard normalisation,
  denormalised over every station and cut to the Korean ones;
* simulation, simulation_avg and wo: RevIN always, the decoder over the
  Korean stations only, ``denorm2``; the CMAQ PM channels (4, 10, 16, 22,
  or 4) are re-normalised through the encoder's RevIN statistics, zero
  padded to every station; wo feeds the decoder zeros.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from vit_grid_model_tpu_torch.models.normalizers import (DishTS, RevIN,
                                                         TimeEncode,
                                                         revin_statistics)
from vit_grid_model_tpu_torch.ops.recurrent import (lstm_cell,
                                                    residual_masked_attention)

TIME_ENCODERS = ("lat_encoder", "lon_encoder", "month_encoder",
                 "day_encoder", "hour_encoder")


@dataclasses.dataclass(frozen=True)
class StationModelSpec:
    input_dim: int = 7
    feat_dim: int = 12
    hidden_dim: int = 128
    pm25_mean: float = 0.0
    pm25_std: float = 1.0
    output_dim: int = 6
    prev_len: int = 100
    korea_stn_num: int = 0
    china_stn_num: int = 0
    normalization_method: str = "DishTS"
    variant: str = "multiair"   # multiair | simulation | simulation_avg | wo

    @property
    def total_stn_num(self) -> int:
        return self.korea_stn_num + self.china_stn_num

    @property
    def enc_dim(self) -> int:
        return self.hidden_dim // 32

    def decoder_input_dim(self) -> int:
        h16 = self.hidden_dim // 16
        if self.variant == "multiair":
            return 16
        if self.variant == "simulation":
            return (self.feat_dim // 2) * 4 + h16 * 4
        if self.variant == "simulation_avg":
            return (self.feat_dim // 2) + h16 * 4
        return h16     # wo


def coordinate_buffer(module: nn.Module, name: str, values) -> None:
    """A non-persistent f32 buffer: coordinates are no state_dict entry."""
    module.register_buffer(
        name, torch.from_numpy(np.array(values, dtype=np.float32)),
        persistent=False)


def time_features(model: nn.Module, raw_times: Tensor,
                  n_tokens: int) -> Tensor:
    """raw_times (B, T, 3) = (month, day, hour) -> (T, B * n_tokens,
    3 * hidden / 16), each row repeated over the tokens."""
    b, t = raw_times.shape[:2]
    tf = torch.cat([getattr(model, enc)(raw_times[:, :, i]).reshape(b, t, -1)
                    for i, enc in enumerate(TIME_ENCODERS[2:])], dim=-1)
    tf = tf.permute(1, 0, 2)[:, :, None, :].expand(t, b, n_tokens,
                                                   tf.shape[-1])
    return tf.reshape(t, b * n_tokens, -1)


def location_features(model: nn.Module, lats: Tensor, lons: Tensor,
                      batch: int) -> Tensor:
    """(batch * points, hidden / 8): the lat and lon encodings of each
    point, repeated over the batch."""
    loc = torch.cat([model.lat_encoder(lats), model.lon_encoder(lons)],
                    dim=-1)
    return loc.expand(batch, *loc.shape).reshape(batch * loc.shape[0], -1)


class StationModel(nn.Module):
    def __init__(self, spec: StationModelSpec, lats, lons):
        super().__init__()
        self.spec = spec
        h = spec.hidden_dim
        stn = spec.total_stn_num
        coordinate_buffer(self, "lats", lats)
        coordinate_buffer(self, "lons", lons)
        for name in TIME_ENCODERS:
            setattr(self, name, TimeEncode(spec.enc_dim))
        self.lstmcell = nn.LSTMCell(spec.feat_dim + h // 16 * 5, h)
        self.decoder = nn.LSTMCell(spec.decoder_input_dim(), h)
        self.last_fc = nn.Linear(h, 1)
        self.hidden_init = nn.Parameter(torch.zeros(stn, h))
        self.cell_init = nn.Parameter(torch.zeros(stn, h))
        if spec.variant == "multiair":
            self.mha = nn.MultiheadAttention(h, 1)
            if spec.normalization_method == "RevIN":
                self.revin_layer = RevIN(stn)
            if spec.normalization_method == "DishTS":
                self.dishts_layer = DishTS(stn, spec.prev_len)
        else:
            self.mha_e = nn.MultiheadAttention(h, 1)
            self.mha_d = nn.MultiheadAttention(h, 1)
            # these variants build a RevIN layer whatever the method
            self.revin_layer = RevIN(stn)
            if spec.variant in ("simulation", "simulation_avg"):
                self.simulation_hour_encoder = TimeEncode(spec.enc_dim)

    def _normalize_pm(self, feats: Tensor, prev_vals: Tensor):
        """Station PM2.5 (feature 0) normalised by the configured method;
        returns (feats, (method, statistics))."""
        spec = self.spec
        pm = feats[..., 0]                                # (B, T_in, stn)
        method = (spec.normalization_method if spec.variant == "multiair"
                  else "RevIN")
        if method == "RevIN":
            stats = revin_statistics(prev_vals, default_mean=spec.pm25_mean,
                                     default_std=spec.pm25_std)
            norm_pm, ctx = self.revin_layer.norm(stats, pm), ("revin", stats)
        elif method == "DishTS":
            norm_pm, stats = self.dishts_layer.norm(pm)
            ctx = ("dishts", stats)
        else:
            norm_pm = (pm - spec.pm25_mean) / spec.pm25_std
            ctx = ("standard", None)
        return torch.cat([norm_pm[..., None], feats[..., 1:]], dim=-1), ctx

    def _encode(self, feats: Tensor, masks: Tensor, time_feat: Tensor,
                loc_feats: Tensor, mha: nn.MultiheadAttention):
        """The encoder's steps: (B, T_in, stn, F) -> the last (h, c)."""
        spec = self.spec
        b, h_dim, stn = feats.shape[0], spec.hidden_dim, spec.total_stn_num
        h = self.hidden_init.expand(b, stn, h_dim)
        c = self.cell_init.expand(b, stn, h_dim).reshape(b * stn, h_dim)
        for i in range(spec.input_dim):
            inp = torch.cat([feats[:, i].reshape(b * stn, -1), time_feat[i],
                             loc_feats], dim=-1)
            h_new, c = lstm_cell(self.lstmcell, inp, h.reshape(b * stn, h_dim),
                                 c)
            h = residual_masked_attention(mha, h_new.reshape(b, stn, h_dim),
                                          masks[:, i])
        return h, c

    def _simulation_input(self, simulation: Tensor, stats, i: int) -> Tensor:
        """Decoder step ``i``'s input of the simulation variants: the CMAQ
        values of lead ``i`` with the PM channels re-normalised through the
        encoder's RevIN statistics, and the lead hours' encoding."""
        spec = self.spec
        b, korea = simulation.shape[:2]
        sim = spec.variant == "simulation"
        s4 = (spec.feat_dim // 2) * (4 if sim else 1)
        sim_vals = simulation[:, :, i * s4:(i + 1) * s4]
        lead = simulation[:, :, -4:] + (i + 1)
        lead_enc = self.simulation_hour_encoder(lead).reshape(b, korea, -1)
        pm_idx = [4, 10, 16, 22] if sim else [4]
        pad = sim_vals.new_zeros(b, spec.total_stn_num - korea, len(pm_idx))
        pm_full = torch.cat([sim_vals[:, :, pm_idx], pad], dim=1)
        pm_norm = self.revin_layer.norm(stats, pm_full.transpose(1, 2))
        sim_vals = sim_vals.clone()
        sim_vals[:, :, pm_idx] = pm_norm[:, :, :korea].transpose(1, 2)
        return torch.cat([sim_vals.reshape(b * korea, -1),
                          lead_enc.reshape(b * korea, -1)], dim=-1)

    def forward(self, feats: Tensor, masks: Tensor, raw_times: Tensor,
                prev_vals: Tensor, sat_outputs: Optional[Tensor] = None,
                sat_inputs: Optional[Tensor] = None,
                simulation: Optional[Tensor] = None) -> Tensor:
        """feats (B, input_dim, stn, F); masks (B, T_in + T_out, stn) bool;
        raw_times (B, T_in + T_out, 3); prev_vals (B, prev_len, stn); the
        variant's extra inputs (MultiAir: sat_outputs (B, stn, T_out) and
        sat_inputs (B, stn, 13); simulation: (B, korea, T_out * s4 + 4)).
        Returns (B, korea_stn_num, output_dim)."""
        spec = self.spec
        b = feats.shape[0]
        stn, korea, h_dim = (spec.total_stn_num, spec.korea_stn_num,
                             spec.hidden_dim)
        multiair = spec.variant == "multiair"

        loc_feats = location_features(self, self.lats, self.lons, b)
        time_feat = time_features(self, raw_times, stn)
        feats, (method, stats) = self._normalize_pm(feats, prev_vals)
        h, c = self._encode(feats, masks, time_feat, loc_feats,
                            self.mha if multiair else self.mha_e)
        dec_mha = self.mha if multiair else self.mha_d

        if multiair:
            n_dec = stn
            sat_mean, sat_std = (
                s[:, None].expand(b, stn, -1).reshape(b * stn, -1)
                for s in (sat_outputs.mean(dim=1),
                          sat_outputs.std(dim=1, correction=1)))
            sat_out = sat_outputs.reshape(b * stn, -1)
            sat_in = sat_inputs.reshape(b * stn, -1)
            sat_in = sat_in.masked_fill(sat_in == -1, 0.0)
        else:
            # the decoder runs over the Korean stations only
            n_dec = korea
            h = h[:, :korea]
            c = c.reshape(b, stn, h_dim)[:, :korea].reshape(b * korea, h_dim)

        preds = []
        for i in range(spec.output_dim):
            if multiair:
                cur = torch.cat([sat_in, sat_out[:, i:i + 1],
                                 sat_mean[:, i:i + 1], sat_std[:, i:i + 1]],
                                dim=-1)
            elif spec.variant == "wo":
                cur = feats.new_zeros(b * korea, h_dim // 16)
            else:
                cur = self._simulation_input(simulation, stats, i)
            h_new, c = lstm_cell(self.decoder, cur,
                                 h.reshape(b * n_dec, h_dim), c)
            h = residual_masked_attention(
                dec_mha, h_new.reshape(b, n_dec, h_dim),
                masks[:, spec.input_dim + i, :n_dec])

            result = self.last_fc(h).transpose(1, 2)      # (B, 1, n_dec)
            if not multiair:
                pred = self.revin_layer.denorm2(stats, result)
            elif method == "revin":
                pred = self.revin_layer.denorm(stats, result)[:, :, :korea]
            elif method == "dishts":
                pred = self.dishts_layer.denorm(stats, result)[:, :, :korea]
            else:
                pred = result[:, :, :korea]
            preds.append(F.relu(pred.transpose(1, 2)))
        return torch.cat(preds, dim=-1)
