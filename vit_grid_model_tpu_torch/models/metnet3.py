"""MetNet3, eval mode: pad -> resnet -> downsample -> MaxViT -> upsample ->
resnet -> 1x1 head, with the per-lead batch expansion and FiLM conditioning.

Counterpart of ``vit_grid_model_tpu/models/metnet3.py::metnet3_apply``
(the PM2.5 regression head).  The compute dtype is the parameters' dtype:
``model.to(torch.bfloat16)`` is the bf16 throughput mode, whose head output
is cast back to f32 before de-standardization.  Quirks kept:

* the PM2.5 cycle channels are standardized inside forward, and the
  output de-standardized;
* the input is padded, centered, to a multiple of 14 and unpadded at the
  end;
* each sample is repeated L times sample-major, with lead times 1..L
  tiled per sample;
* the time conditioning reads timestamps row 6;
* the month/day/hour embeddings are concatenated along dim 0 and then
  viewed per row, which mixes rows across the batch.

``cfg.fuse_lead_stem`` and ``cfg.nhwc_input`` select the lead-factorized
stem and the host-prepared (B, Hp, Wp, T*C) input, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor, nn

from vit_grid_model_tpu.core.config import MetNet3Config
from vit_grid_model_tpu_torch.models.maxvit import MaxViT
from vit_grid_model_tpu_torch.ops import nn as vnn

# ---------------------------------------------------------------------------
# conditionable resnet blocks
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """3x3 conv -> ChanLayerNorm -> optional (scale + 1, shift) -> ReLU."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Conv2d(dim_in, dim_out, 3, padding=1)
        self.norm = vnn.ChanLayerNorm(dim_out)

    def forward(self, x: Tensor,
                scale_shift: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
        x = vnn.conv2d(x, self.proj.weight, self.proj.bias, padding=1)
        return _norm_act(self.norm, x, scale_shift)


def _norm_act(norm: vnn.ChanLayerNorm, x: Tensor,
              scale_shift: Optional[Tuple[Tensor, Tensor]]) -> Tensor:
    x = norm(x)
    if scale_shift is not None:
        scale, shift = scale_shift
        x = x * (scale + 1.0) + shift
    return torch.relu(x)


class ResnetBlock(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, cond_dim: Optional[int]):
        super().__init__()
        self.block1 = Block(dim_in, dim_out)
        self.block2 = Block(dim_out, dim_out)
        self.mlp = (nn.Sequential(nn.ReLU(), nn.Linear(cond_dim, dim_out * 2))
                    if cond_dim is not None else None)
        self.res_conv = (nn.Conv2d(dim_in, dim_out, 1) if dim_in != dim_out
                         else None)

    def scale_shift(self, cond: Optional[Tensor]):
        if self.mlp is None or cond is None:
            return None
        fc = self.mlp[1]
        c = vnn.linear(torch.relu(cond), fc.weight, fc.bias)
        scale, shift = c.chunk(2, dim=-1)
        return scale[:, :, None, None], shift[:, :, None, None]

    def forward(self, x: Tensor, cond: Optional[Tensor] = None) -> Tensor:
        h = self.block1(x, self.scale_shift(cond))
        h = self.block2(h)
        res = (vnn.conv2d(x, self.res_conv.weight, self.res_conv.bias)
               if self.res_conv is not None else x)
        return h + res


class ResnetBlocks(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, depth: int,
                 cond_dim: Optional[int]):
        super().__init__()
        self.blocks = nn.ModuleList(
            ResnetBlock(dim_in if i == 0 else dim_out, dim_out, cond_dim)
            for i in range(depth))

    def forward(self, x: Tensor, cond: Optional[Tensor] = None) -> Tensor:
        for block in self.blocks:
            x = block(x, cond)
        return x


# ---------------------------------------------------------------------------
# padding and in-forward standardization
# ---------------------------------------------------------------------------


def pad_values(h: int, w: int, pad_size: int = 14) -> Tuple[int, int, int, int]:
    """(left, right, top, bottom) zero padding centering (h, w) into the next
    multiple of ``pad_size``."""
    pad_h = (pad_size - h) % pad_size
    pad_w = (pad_size - w) % pad_size
    return pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2


def pad_hw(x: Tensor, pad_size: int = 14):
    """Pad the H and W axes of an NCHW tensor; returns (x, (l, r, t, b))."""
    pv = pad_values(x.shape[-2], x.shape[-1], pad_size)
    return nn.functional.pad(x, pv), pv


def unpad_hw(x: Tensor, pv: Tuple[int, int, int, int]) -> Tensor:
    l, r, t, b = pv
    return x[:, :, t:x.shape[-2] - b, l:x.shape[-1] - r]


def _pm_channels(cfg: MetNet3Config):
    idx = list(cfg.pm25_channel_indices)
    if cfg.stn_img_channel is not None:
        idx.append(cfg.stn_img_channel)
    return idx


def standardize_pm_channels(x: Tensor, cfg: MetNet3Config) -> Tensor:
    """(B, T, C, H, W): standardize the PM channels with the global
    mean/std (the dataset standardized the other species)."""
    if cfg.normalization_method != "Standard":
        return x
    idx = _pm_channels(cfg)
    x = x.clone()
    x[:, :, idx] = (x[:, :, idx] - cfg.pm25_mean) / cfg.pm25_std
    return x


def standardize_pm_channels_nhwc(x: Tensor, cfg: MetNet3Config,
                                 pv: Tuple[int, int, int, int]) -> Tensor:
    """``standardize_pm_channels`` for the zero-padded (B, Hp, Wp, T*C)
    layout: only PM channels of interior pixels change, so the padded
    border stays zero."""
    if cfg.normalization_method != "Standard":
        return x
    l, r, t, b = pv
    hp, wp, tc = x.shape[1:]
    dev = x.device
    hh = torch.arange(hp, device=dev)[:, None, None]
    ww = torch.arange(wp, device=dev)[None, :, None]
    cc = torch.arange(tc, device=dev)[None, None, :] % cfg.n_variables
    interior = (hh >= t) & (hh < hp - b) & (ww >= l) & (ww < wp - r)
    chan = torch.zeros_like(cc, dtype=torch.bool)
    for c in _pm_channels(cfg):
        chan = chan | (cc == c)
    return torch.where(interior & chan, (x - cfg.pm25_mean) / cfg.pm25_std, x)


# ---------------------------------------------------------------------------
# MetNet3
# ---------------------------------------------------------------------------


class MetNet3(nn.Module):
    """State_dict keys are those of
    ``core/torch_export.py::export_metnet3_state_dict``."""

    def __init__(self, cfg: MetNet3Config):
        super().__init__()
        unsupported = [name for name in ("pm10", "direct_regional",
                                          "pm25_class_head", "int8_convs",
                                          "fold_bn_eval")
                       if getattr(cfg, name)]
        if unsupported or not cfg.pm25:
            raise ValueError(f"MetNet3: not ported: {unsupported or ['pm25']}")
        self.cfg = cfg
        ch = cfg.n_start_channels
        emb = cfg.model_time_emb_dim
        n_in = cfg.n_input_channels
        if cfg.concat_time_to_input:
            n_in += cfg.lead_time_emb_dim + emb * 3
        self.condition_lead_time = nn.Embedding(cfg.end_lead_time + 1,
                                                cfg.lead_time_emb_dim)
        self.condition_model_time = nn.ModuleList(
            [nn.Embedding(12 + 1, emb), nn.Embedding(31 + 1, emb),
             nn.Embedding(24 + 1, emb)])
        self.resnet1 = ResnetBlocks(n_in, ch, cfg.resnet_block_depth,
                                    cfg.lead_time_emb_dim)
        self.vit = MaxViT(
            ch, depth=cfg.depth_tuple, cond_dim=cfg.lead_time_emb_dim,
            heads=cfg.n_heads, dim_head=cfg.dim_head,
            window_size=cfg.vit_window_size,
            mbconv_expansion_rate=cfg.mbconv_expansion_rate,
            mbconv_shrinkage_rate=cfg.mbconv_shrinkage_rate,
            num_register_tokens=cfg.num_register_tokens)
        self.up = nn.ConvTranspose2d(ch, ch, 2, stride=2)
        self.resnet2 = ResnetBlocks(ch, ch, cfg.resnet_block_depth,
                                    cfg.lead_time_emb_dim)
        self.classifier_pm25 = nn.Conv2d(ch, 1, 1)
        self.register_buffer("pm25_boundaries",
                             torch.tensor(cfg.pm25_boundaries))

    def _condition_time(self, target_time: Tensor, bl: int) -> Tensor:
        """target_time: (B*L, 5) rows of (year, month, day, hour, lead).
        Returns (B*L, lead_emb_dim + 3*model_time_emb_dim) with the dim-0
        concat of the month/day/hour embeddings viewed per row."""
        lead_emb = self.condition_lead_time(target_time[:, -1].long())
        model_time = target_time[:, 1:-1].long()
        embs = [emb(model_time[:, i])
                for i, emb in enumerate(self.condition_model_time)]
        scrambled = torch.cat(embs, dim=0).reshape(bl, -1)
        return torch.cat([lead_emb, scrambled], dim=-1)

    def _fused_lead_stem(self, x: Tensor, time_feats: Tensor, cond: Tensor,
                         L: int) -> Tensor:
        """conv(concat(x, t)) == conv_x(x) + conv_t(t): the shared-channel
        conv runs once per sample, and the spatially constant time channels
        reduce to time_feats times the border-aware maps conv(ones)."""
        first = self.resnet1.blocks[0]
        proj = first.block1.proj
        w = proj.weight                                     # (O, C_in, 3, 3)
        n_time = time_feats.shape[-1]
        n_shared = w.shape[1] - n_time
        hp, wp = x.shape[-2:]

        y = vnn.conv2d(x, w[:, :n_shared], proj.bias, padding=1)
        y = y.repeat_interleave(L, dim=0)
        ones = torch.ones(1, 1, hp, wp, dtype=x.dtype, device=x.device)
        k_maps = vnn.conv2d(ones, w[:, n_shared:].reshape(-1, 1, 3, 3),
                            padding=1).reshape(w.shape[0], n_time, hp, wp)
        y = y + torch.einsum("bj,ojhw->bohw", time_feats, k_maps)
        h = _norm_act(first.block1.norm, y, first.scale_shift(cond))
        h = first.block2(h)

        res_w = first.res_conv.weight                       # (O, C_in, 1, 1)
        res = vnn.conv2d(x, res_w[:, :n_shared]).repeat_interleave(L, dim=0)
        res = res + vnn.linear(time_feats,
                               res_w[:, n_shared:, 0, 0])[:, :, None, None]
        res = res + first.res_conv.bias[:, None, None]
        out = h + res
        for block in self.resnet1.blocks[1:]:
            out = block(out, cond)
        return out

    def forward(self, x: Tensor, timestamps: Tensor) -> Tensor:
        """x: (B, T, C, H, W), or (B, Hp, Wp, T*C) zero-padded with the PM
        channels raw when ``cfg.nhwc_input``; timestamps: (B, T', 4) raw
        (year, month, day, hour) rows.  Returns (B, L, H, W) f32 fields."""
        cfg = self.cfg
        B = x.shape[0]
        L = cfg.end_lead_time
        dtype = self.up.weight.dtype

        lead_times = torch.arange(1, L + 1, device=x.device).repeat(B)
        cond = self.condition_lead_time(lead_times)

        if cfg.nhwc_input:
            H, Wd = cfg.input_height, cfg.input_width
            pv = pad_values(H, Wd, cfg.pad_multiple)
            l, r, t, b = pv
            expect = (H + t + b, Wd + l + r, cfg.window_size * cfg.n_variables)
            if tuple(x.shape[1:]) != expect:
                raise ValueError(f"nhwc_input expects (B,{expect[0]},"
                                 f"{expect[1]},{expect[2]}), got "
                                 f"{tuple(x.shape)}")
            x = standardize_pm_channels_nhwc(x.to(dtype), cfg, pv)
            x = x.permute(0, 3, 1, 2)                      # channels_last NCHW
        else:
            _, T, C, H, Wd = x.shape
            x = standardize_pm_channels(x, cfg).reshape(B, T * C, H, Wd)
            x, pv = pad_hw(x, cfg.pad_multiple)
            x = x.contiguous(memory_format=torch.channels_last)
        hp, wp = x.shape[-2:]

        time_feats = None
        if cfg.concat_time_to_input:
            ts6 = timestamps[:, 6, :].repeat_interleave(L, dim=0)   # (BL, 4)
            ts6 = torch.cat([ts6, lead_times[:, None].to(ts6.dtype)], dim=-1)
            time_feats = self._condition_time(ts6, B * L)

        x = x.to(dtype)
        cond = cond.to(dtype)
        if cfg.fuse_lead_stem and time_feats is not None:
            out = self._fused_lead_stem(x, time_feats.to(dtype), cond, L)
        else:
            x = x.repeat_interleave(L, dim=0)
            if time_feats is not None:
                maps = time_feats[:, :, None, None].expand(-1, -1, hp, wp)
                x = torch.cat([x, maps.to(x.dtype)], dim=1)
            out = self.resnet1(x, cond)
        out = vnn.max_pool_2x(out)
        out = self.vit(out, cond)
        out = vnn.conv2d_transpose(out, self.up.weight, self.up.bias, stride=2)
        out = self.resnet2(out, cond)
        out = unpad_hw(out, pv)

        head = self.classifier_pm25
        preds = vnn.conv2d(out, head.weight, head.bias)
        preds = preds[:, 0].reshape(B, L, H, Wd).float()
        if cfg.normalization_method == "Standard":
            preds = preds * cfg.pm25_std + cfg.pm25_mean
        return preds
