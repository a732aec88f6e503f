"""A ``metnet3_init``-shaped parameter tree (nested dicts of arrays numpy can
read) -> the reference ``MetNet3`` state_dict as numpy arrays.

The port's own copy of the MetNet3 part of
``vit_grid_model_tpu/core/torch_export.py``.  It works on numpy only, and
``core/weights.py::params_from_jax`` loads its output into the port's
``MetNet3`` with a strict ``load_state_dict``.  Layout changes:

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
