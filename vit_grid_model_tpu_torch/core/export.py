"""JAX parameter trees (nested dicts of arrays numpy can read) -> the
reference modules' state_dicts as numpy arrays: ``MetNet3``, the legacy
station and grid models, and SimVP.

The port's own copy of the exporters of
``vit_grid_model_tpu/core/torch_export.py``.  It works on numpy only, and
``core/weights.py`` loads its output into the port's modules with a strict
``load_state_dict``.  Layout changes:

* conv kernels   HWIO -> OIHW
* linear weights (in, out) -> (out, in)
* conv-transpose kernels: un-flip the spatial taps, (kh,kw,in,out) ->
  torch's (in, out, kh, kw)
* ChanLayerNorm vectors (C,) -> torch's (1, C, 1, 1)
* BatchNorm gains its ``num_batches_tracked`` counter (0)
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from vit_grid_model_tpu_torch.core.config import MetNet3Config


def _f32(a) -> np.ndarray:
    # np.array (not asarray): read-only views would make torch.from_numpy
    # undefined behavior
    return np.array(a, dtype=np.float32)


def _conv(w) -> np.ndarray:
    """HWIO -> OIHW."""
    return np.transpose(_f32(w), (3, 2, 0, 1))


def _conv_transpose(w) -> np.ndarray:
    """Flipped HWIO (kh, kw, in, out) -> torch ConvTranspose2d
    (in, out, kh, kw)."""
    w = np.transpose(_f32(w), (2, 3, 0, 1))
    return np.flip(w, axis=(2, 3)).copy()


def _lin(w) -> np.ndarray:
    return np.transpose(_f32(w)).copy()


def _emit_conv(out, prefix, p) -> None:
    out[f"{prefix}.weight"] = _conv(p["w"])
    if "b" in p:
        out[f"{prefix}.bias"] = _f32(p["b"])


def _emit_lin(out, prefix, p) -> None:
    out[f"{prefix}.weight"] = _lin(p["w"])
    if "b" in p:
        out[f"{prefix}.bias"] = _f32(p["b"])


def _emit_bn(out, prefix, p) -> None:
    out[f"{prefix}.weight"] = _f32(p["scale"])
    out[f"{prefix}.bias"] = _f32(p["bias"])
    out[f"{prefix}.running_mean"] = _f32(p["mean"])
    out[f"{prefix}.running_var"] = _f32(p["var"])
    out[f"{prefix}.num_batches_tracked"] = np.array(0, dtype=np.int64)


def _emit_block(out, prefix, p) -> None:
    """Block = Conv2d proj + ChanLayerNorm; the norm's g/b are
    (1, C, 1, 1) in torch."""
    _emit_conv(out, f"{prefix}.proj", p["proj"])
    out[f"{prefix}.norm.g"] = _f32(p["norm"]["g"]).reshape(1, -1, 1, 1)
    out[f"{prefix}.norm.b"] = _f32(p["norm"]["b"]).reshape(1, -1, 1, 1)


def _emit_resnet_block(out, prefix, p) -> None:
    _emit_block(out, f"{prefix}.block1", p["block1"])
    _emit_block(out, f"{prefix}.block2", p["block2"])
    if "mlp" in p:                       # Sequential(ReLU, Linear) -> .1
        _emit_lin(out, f"{prefix}.mlp.1", p["mlp"])
    if "res_conv" in p:
        _emit_conv(out, f"{prefix}.res_conv", p["res_conv"])


def _emit_mbconv(out, prefix, p, *, residual: bool) -> None:
    """MBConv Sequential indices (0, 1, 3, 4, 6, 7, 8); a residual block
    nests them under ``fn.``."""
    if residual:
        prefix = f"{prefix}.fn"
    _emit_conv(out, f"{prefix}.0", p["expand"])
    _emit_bn(out, f"{prefix}.1", p["bn1"])
    _emit_conv(out, f"{prefix}.3", p["dw"])
    _emit_bn(out, f"{prefix}.4", p["bn2"])
    _emit_lin(out, f"{prefix}.6.gate.1", p["se"]["fc1"])   # bias=False
    _emit_lin(out, f"{prefix}.6.gate.3", p["se"]["fc2"])   # bias=False
    _emit_conv(out, f"{prefix}.7", p["project"])
    _emit_bn(out, f"{prefix}.8", p["bn3"])


def _emit_attention(out, prefix, p) -> None:
    if p.get("norm"):                    # affine LayerNorm only when uncond
        out[f"{prefix}.norm.weight"] = _f32(p["norm"]["g"])
        out[f"{prefix}.norm.bias"] = _f32(p["norm"]["b"])
    if "film" in p:                      # Sequential(Linear, SiLU, Linear)
        _emit_lin(out, f"{prefix}.film.0", p["film"]["fc1"])
        _emit_lin(out, f"{prefix}.film.2", p["film"]["fc2"])
    _emit_lin(out, f"{prefix}.to_qkv", p["to_qkv"])        # bias=False
    out[f"{prefix}.q_norm.gamma"] = _f32(p["q_norm"]["gamma"])
    out[f"{prefix}.k_norm.gamma"] = _f32(p["k_norm"]["gamma"])
    _emit_lin(out, f"{prefix}.to_out.0", p["to_out"])      # bias=False
    out[f"{prefix}.rel_pos_bias.weight"] = _f32(p["rel_pos_bias"]["table"])


def export_metnet3_state_dict(params, cfg: MetNet3Config
                              ) -> Dict[str, np.ndarray]:
    """``metnet3_init``-shaped tree -> reference ``MetNet3`` state_dict
    ({name: numpy})."""
    out: Dict[str, np.ndarray] = {}
    out["condition_lead_time.weight"] = _f32(
        params["condition_lead_time"]["table"])
    for i, emb in enumerate(params["condition_model_time"]):
        out[f"condition_model_time.{i}.weight"] = _f32(emb["table"])
    for name in ("resnet1", "resnet2"):
        for i, blk in enumerate(params[name]["blocks"]):
            _emit_resnet_block(out, f"{name}.blocks.{i}", blk)
    flat = 0
    for depth in cfg.depth_tuple:
        for ind in range(depth):
            layer = params["vit"]["layers"][flat]
            _emit_mbconv(out, f"vit.layers.{flat}.0", layer["conv"],
                         residual=ind > 0)
            _emit_attention(out, f"vit.layers.{flat}.1", layer["block_attn"])
            _emit_attention(out, f"vit.layers.{flat}.2", layer["grid_attn"])
            out[f"vit.register_tokens.{flat}"] = _f32(
                layer["register_tokens"])
            flat += 1
    out["up.weight"] = _conv_transpose(params["up"]["w"])
    out["up.bias"] = _f32(params["up"]["b"])
    # class boundaries are persistent torch buffers, one per enabled head
    for head, bounds in (("classifier_pm25", cfg.pm25_boundaries),
                         ("classifier_pm10", cfg.pm10_boundaries)):
        if head in params:
            _emit_conv(out, head, params[head])
            out[head.replace("classifier_", "") + "_boundaries"] = _f32(
                bounds)
    return out


# ---------------------------------------------------------------------------
# the legacy model family and SimVP.  lats, lons and cmaq_coords are plain
# attributes of the reference modules, not state_dict entries, so they are
# left out
# ---------------------------------------------------------------------------

def _emit_lstm(out, prefix, p) -> None:
    out[f"{prefix}.weight_ih"] = _f32(p["w_ih"])
    out[f"{prefix}.weight_hh"] = _f32(p["w_hh"])
    out[f"{prefix}.bias_ih"] = _f32(p["b_ih"])
    out[f"{prefix}.bias_hh"] = _f32(p["b_hh"])


def _emit_mha(out, prefix, p) -> None:
    out[f"{prefix}.in_proj_weight"] = _f32(p["in_proj_w"])
    out[f"{prefix}.in_proj_bias"] = _f32(p["in_proj_b"])
    _emit_lin(out, f"{prefix}.out_proj", p["out_proj"])


def _emit_time_encode(out, prefix, p) -> None:
    out[f"{prefix}.w.weight"] = _f32(p["w"])     # stored in torch layout
    out[f"{prefix}.w.bias"] = _f32(p["b"])


def _emit_revin(out, prefix, p) -> None:
    if p:                                        # affine params only
        out[f"{prefix}.affine_weight"] = _f32(p["affine_weight"])
        out[f"{prefix}.affine_bias"] = _f32(p["affine_bias"])


def _emit_dishts(out, prefix, p) -> None:
    out[f"{prefix}.reduce_mlayer"] = _f32(p["reduce_mlayer"])
    out[f"{prefix}.gamma"] = _f32(p["gamma"])
    out[f"{prefix}.beta"] = _f32(p["beta"])


_TIME_ENCODERS = ("lat_encoder", "lon_encoder", "month_encoder",
                  "day_encoder", "hour_encoder")


def export_station_model(params, variant: str) -> Dict[str, np.ndarray]:
    """``station_model_init``-shaped tree -> reference MultiAir /
    simulation_model(_avg) / wo_simulation_model state_dict."""
    out: Dict[str, np.ndarray] = {}
    _emit_lstm(out, "lstmcell", params["lstmcell"])
    _emit_lstm(out, "decoder", params["decoder"])
    _emit_lin(out, "last_fc", params["last_fc"])
    out["hidden_init"] = _f32(params["hidden_init"])
    out["cell_init"] = _f32(params["cell_init"])
    for enc in _TIME_ENCODERS:
        _emit_time_encode(out, enc, params[enc])
    if variant == "multiair":
        _emit_mha(out, "mha", params["mha"])
    else:
        _emit_mha(out, "mha_e", params["mha_e"])
        _emit_mha(out, "mha_d", params["mha_d"])
        if "simulation_hour_encoder" in params:
            _emit_time_encode(out, "simulation_hour_encoder",
                              params["simulation_hour_encoder"])
    if params.get("revin_layer"):
        _emit_revin(out, "revin_layer", params["revin_layer"])
    if params.get("dishts_layer"):
        _emit_dishts(out, "dishts_layer", params["dishts_layer"])
    return out


def export_grid_model(params, version: int) -> Dict[str, np.ndarray]:
    """``grid_model_init``-shaped tree -> reference
    simulation_grid_model{,_v2,_v3} state_dict.  v1's decode-only grid LSTM
    is named ``grid_decoder_lstm``."""
    out: Dict[str, np.ndarray] = {}
    _emit_lstm(out, "station_encoder_lstm", params["station_encoder_lstm"])
    _emit_lstm(out, "station_decoder_lstm", params["station_decoder_lstm"])
    _emit_lstm(out, "grid_decoder_lstm" if version == 1 else "grid_lstm",
               params["grid_lstm"])
    _emit_mha(out, "mha_e", params["mha_e"])
    _emit_mha(out, "mha_d", params["mha_d"])
    _emit_lin(out, "last_fc", params["last_fc"])
    for name in ("station_hidden_init", "station_cell_init",
                 "grid_hidden_init", "grid_cell_init"):
        out[name] = _f32(params[name])
    _emit_time_encode(out, "simulation_hour_encoder",
                      params["simulation_hour_encoder"])
    for enc in _TIME_ENCODERS:
        _emit_time_encode(out, enc, params[enc])
    if params.get("revin_layer"):
        _emit_revin(out, "revin_layer", params["revin_layer"])
    if params.get("dishts_layer"):
        _emit_dishts(out, "dishts_layer", params["dishts_layer"])
    return out


def _emit_basic_conv(out, prefix, p, *, transpose: bool) -> None:
    """BasicConv2d = Conv2d or ConvTranspose2d + GroupNorm."""
    w = p["conv"]["w"]
    out[f"{prefix}.conv.weight"] = (_conv_transpose(w) if transpose
                                    else _conv(w))
    if "b" in p["conv"]:
        out[f"{prefix}.conv.bias"] = _f32(p["conv"]["b"])
    out[f"{prefix}.norm.weight"] = _f32(p["norm"]["g"])
    out[f"{prefix}.norm.bias"] = _f32(p["norm"]["b"])


def export_simvp(params, n_s: int, n_t: int) -> Dict[str, np.ndarray]:
    """``simvp_init``-shaped tree -> reference SimVP_adv state_dict.
    Decoder convs at stride-2 positions are ConvTranspose2d in torch
    (positions from ``stride_generator(reverse=True)``)."""
    from vit_grid_model_tpu_torch.models.simvp import stride_generator

    out: Dict[str, np.ndarray] = {}
    for i, layer in enumerate(params["enc"]["enc"]):
        _emit_basic_conv(out, f"enc.enc.{i}.conv", layer, transpose=False)
    dec_strides = stride_generator(n_s, reverse=True)
    for i, layer in enumerate(params["dec"]["dec"]):
        _emit_basic_conv(out, f"dec.dec.{i}.conv", layer,
                         transpose=dec_strides[i] == 2)
    _emit_conv(out, "dec.readout", params["dec"]["readout"])
    for half in ("enc", "dec"):
        for i, inc in enumerate(params["hid"][half]):
            _emit_conv(out, f"hid.{half}.{i}.conv1", inc["conv1"])
            for j, br in enumerate(inc["layers"]):
                _emit_basic_conv(out, f"hid.{half}.{i}.layers.{j}", br,
                                 transpose=False)
    return out
