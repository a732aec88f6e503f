"""MetNet3: pad -> resnet -> downsample -> MaxViT -> upsample -> resnet ->
1x1 head, with the per-lead batch expansion and FiLM conditioning.

Counterpart of ``vit_grid_model_tpu/models/metnet3.py``: ``forward`` is
``metnet3_apply``, ``class_outputs`` is ``metnet3_class_outputs`` and
``get_ignore_keys_for_eval`` its namesake.  The compute dtype is the
parameters' dtype:
``model.to(torch.bfloat16)`` is the bf16 throughput mode, whose head output
is cast back to f32 before de-standardization (training runs bf16 over f32
master weights through ``train/trainer.py::model_forward``).  In training
mode (``model.train()``) the MBConv batch-norms use batch statistics and
the window attention drops out at ``cfg.dropout``.  Quirks kept:

* the PM2.5 cycle channels are standardized inside forward, and the
  output de-standardized;
* the input is padded, centered, to a multiple of 14 and unpadded at the
  end;
* each sample is repeated L times sample-major, with lead times 1..L
  tiled per sample;
* the time conditioning reads timestamps row 6, clamped to the last row
  for shorter windows, as JAX's gather clamps;
* the month/day/hour embeddings are concatenated along dim 0 and then
  viewed per row, which mixes rows across the batch.

Data parallel (``forward(..., group=...)``): ``x`` holds this rank's rows
of a global batch and ``timestamps`` the global batch's.  The time
conditioning is computed over the global batch and this rank's rows taken
(the mixing above reads other ranks' rows), the MBConv batch-norms take
their statistics over the global batch, and each attention's dropout seed
is offset per rank as the JAX package's sharded kernels offset it, so that
the ranks together compute what one process computes on the global batch.

``cfg.fuse_lead_stem`` and ``cfg.nhwc_input`` select the lead-factorized
stem and the host-prepared (B, Hp, Wp, T*C) input, and ``cfg.fold_bn_eval``
the MBConv with its batch-norms folded (inference only), as in the JAX
package.

Spans (``utils/profiling.py::annotate``): ``metnet3.forward``, or
``metnet3.class_outputs``, holds ``metnet3.input`` (standardise, pad,
layout, time features), ``metnet3.stem`` (the lead stem and the
max-pool), ``metnet3.vit``, ``metnet3.up``, ``metnet3.resnet2`` and
``metnet3.head``.

Heads (state_dict keys of ``core/export.py`` unless noted):

* ``classifier_pm25``, under ``cfg.pm25``: a 1x1 conv with one output, or
  ``len(pm25_boundaries) + 1`` class logits under ``cfg.pm25_class_head``
  (the regression forward then returns class 0's logit de-standardized,
  as ``metnet3_apply`` does), with its ``pm25_boundaries`` buffer;
* ``classifier_pm10`` and ``pm10_boundaries``, under ``cfg.pm10``;
* ``regr_regional_pm25`` / ``_pm10``, under ``cfg.direct_regional``:
  ``nn.Sequential(Conv2d(ch, 1, 1), Flatten(), Linear(H * W, 19))``, keys
  ``.0.*`` and ``.2.*`` (the names the reference's own ``nn.Sequential``
  would give; ``core/weights.py`` carries them from a JAX pytree).
  (BL, 1, H, W) flattens in the (H, W) row-major order of JAX's
  (BL, H, W, 1).

int8 (``cfg.int8_convs``, eval only): a resnet ``Block`` with an int8
sidecar ``proj_q`` (``ops/quantize.py``, keys ``*.proj_q.{wq, sw, sx,
b}``, attached by ``quantize_metnet3_int8``) runs its 3x3 conv in int8,
the fused stem's ``block2`` included; without a sidecar, or with the flag
off, the float conv.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import Tensor, nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from vit_grid_model_tpu_torch.core import distributed
from vit_grid_model_tpu_torch.core.config import MetNet3Config
from vit_grid_model_tpu_torch.models.classification import (
    categorical_to_continuous)
from vit_grid_model_tpu_torch.models.maxvit import MaxViT
from vit_grid_model_tpu_torch.ops import nn as vnn
from vit_grid_model_tpu_torch.ops import quantize as Q
from vit_grid_model_tpu_torch.ops.cuda import norm_act as cuda_norm_act
from vit_grid_model_tpu_torch.train import losses as L
from vit_grid_model_tpu_torch.utils.profiling import annotate

# ---------------------------------------------------------------------------
# conditionable resnet blocks
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """3x3 conv -> ChanLayerNorm -> optional (scale + 1, shift) -> ReLU ->
    optional residual add.  ``proj_q``: the conv's int8 sidecar
    (``ops/quantize.py``), or None."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Conv2d(dim_in, dim_out, 3, padding=1)
        self.norm = vnn.ChanLayerNorm(dim_out)
        self.proj_q: Optional[Q.Int8Conv] = None

    def forward(self, x: Tensor,
                scale_shift: Optional[Tuple[Tensor, Tensor]] = None, *,
                residual: Optional[Tensor] = None, int8: bool = False,
                collect_amax: Optional[Dict[str, Tensor]] = None,
                site: Optional[str] = None) -> Tensor:
        """``residual``: added after the ReLU; ``int8``: take the int8
        sidecar where there is one; ``collect_amax``: record max-|x| under
        ``site`` (calibration)."""
        if collect_amax is not None and site is not None:
            Q.record_amax(collect_amax, site, x)
        if int8 and self.proj_q is not None:
            x = Q.conv2d_int8(self.proj_q, x)
        else:
            x = vnn.conv2d(x, self.proj.weight, self.proj.bias, padding=1)
        return _norm_act(self.norm, x, scale_shift, residual)


def _norm_act(norm: vnn.ChanLayerNorm, x: Tensor,
              scale_shift: Optional[Tuple[Tensor, Tensor]],
              residual: Optional[Tensor] = None) -> Tensor:
    """ChanLayerNorm -> (scale + 1, shift) -> ReLU -> + residual: on CUDA
    one kernel (``ops/cuda/norm_act.py``) wherever it takes the operands (a
    forward that needs no gradient), else the eager ops."""
    if x.is_cuda:
        form = cuda_norm_act.route(x, norm.g, norm.b, scale_shift, residual)
        if form is not None:
            return cuda_norm_act.launch(form, x, norm.g, norm.b, scale_shift,
                                        residual)
        cuda_norm_act.count_eager()
    return _norm_act_eager(norm, x, scale_shift, residual)


def _norm_act_eager(norm: vnn.ChanLayerNorm, x: Tensor,
                    scale_shift: Optional[Tuple[Tensor, Tensor]],
                    residual: Optional[Tensor] = None) -> Tensor:
    """``_norm_act`` as separate ATen ops, each rounding to x's dtype."""
    x = norm(x)
    if scale_shift is not None:
        scale, shift = scale_shift
        x = x * (scale + 1.0) + shift
    x = torch.relu(x)
    return x if residual is None else x + residual


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

    def forward(self, x: Tensor, cond: Optional[Tensor] = None, *,
                int8: bool = False,
                collect_amax: Optional[Dict[str, Tensor]] = None,
                site: Optional[str] = None) -> Tensor:
        def kw(block):
            return dict(int8=int8, collect_amax=collect_amax,
                        site=f"{site}.{block}" if site else None)

        res = (vnn.conv2d(x, self.res_conv.weight, self.res_conv.bias)
               if self.res_conv is not None else x)
        h = self.block1(x, self.scale_shift(cond), **kw("block1"))
        return self.block2(h, residual=res, **kw("block2"))


class ResnetBlocks(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, depth: int,
                 cond_dim: Optional[int]):
        super().__init__()
        self.blocks = nn.ModuleList(
            ResnetBlock(dim_in if i == 0 else dim_out, dim_out, cond_dim)
            for i in range(depth))

    def forward(self, x: Tensor, cond: Optional[Tensor] = None, *,
                int8: bool = False,
                collect_amax: Optional[Dict[str, Tensor]] = None,
                site: Optional[str] = None) -> Tensor:
        """``site``: the stage's name ("resnet1"), from which block i's
        convs are named "resnet1.i.block1" and "resnet1.i.block2"."""
        for i, block in enumerate(self.blocks):
            x = block(x, cond, int8=int8, collect_amax=collect_amax,
                      site=f"{site}.{i}" if site else None)
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


#: added to a dropout seed once per rank, in int32 wraparound, as
#: ``vit_grid_model_tpu/ops/pallas/attention.py::window_attention_pallas_
#: sharded`` adds ``axis_index * 0x3C6EF35F`` inside each shard
SEED_STRIDE = 0x3C6EF35F


def rank_seed(seed: int, rank: int) -> int:
    """int32(seed + int32(rank * SEED_STRIDE)), wrapping as int32 does: the
    product overflows from rank 3 on, the sum from rank 1 on."""
    return (seed + rank * SEED_STRIDE + 2 ** 31) % 2 ** 32 - 2 ** 31


# ---------------------------------------------------------------------------
# MetNet3
# ---------------------------------------------------------------------------


class MetNet3(nn.Module):
    """State_dict keys are those of
    ``core/torch_export.py::export_metnet3_state_dict``, plus the regional
    heads and the int8 sidecars (see the module docstring)."""

    def __init__(self, cfg: MetNet3Config):
        super().__init__()
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
            num_register_tokens=cfg.num_register_tokens, dropout=cfg.dropout,
            fold_bn_eval=cfg.fold_bn_eval)
        self.up = nn.ConvTranspose2d(ch, ch, 2, stride=2)
        self.resnet2 = ResnetBlocks(ch, ch, cfg.resnet_block_depth,
                                    cfg.lead_time_emb_dim)
        # the regression head, or with pm25_class_head the class logits
        if cfg.pm25:
            n_out = (len(cfg.pm25_boundaries) + 1 if cfg.pm25_class_head
                     else 1)
            self.classifier_pm25 = nn.Conv2d(ch, n_out, 1)
            self.register_buffer("pm25_boundaries",
                                 torch.tensor(cfg.pm25_boundaries))
            if cfg.direct_regional:
                self.regr_regional_pm25 = self._regional_head(ch)
        if cfg.pm10:
            self.classifier_pm10 = nn.Conv2d(
                ch, len(cfg.pm10_boundaries) + 1, 1)
            self.register_buffer("pm10_boundaries",
                                 torch.tensor(cfg.pm10_boundaries))
            if cfg.direct_regional:
                self.regr_regional_pm10 = self._regional_head(ch)

    def _regional_head(self, ch: int) -> nn.Sequential:
        """Conv1x1 -> flatten (H, W) row-major -> Linear(H * W, 19)."""
        cfg = self.cfg
        return nn.Sequential(nn.Conv2d(ch, 1, 1), nn.Flatten(),
                             nn.Linear(cfg.input_height * cfg.input_width,
                                       19))

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
                         L: int, int8: bool,
                         collect_amax: Optional[Dict[str, Tensor]]) -> Tensor:
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

        res_w = first.res_conv.weight                       # (O, C_in, 1, 1)
        res = vnn.conv2d(x, res_w[:, :n_shared]).repeat_interleave(L, dim=0)
        res = res + vnn.linear(time_feats,
                               res_w[:, n_shared:, 0, 0])[:, :, None, None]
        res = res + first.res_conv.bias[:, None, None]
        h = _norm_act(first.block1.norm, y, first.scale_shift(cond))
        out = first.block2(h, residual=res, int8=int8,
                           collect_amax=collect_amax, site="resnet1.0.block2")
        for i, block in enumerate(self.resnet1.blocks[1:], start=1):
            out = block(out, cond, int8=int8, collect_amax=collect_amax,
                        site=f"resnet1.{i}")
        return out

    def forward(self, x: Tensor, timestamps: Tensor, *,
                generator: Optional[torch.Generator] = None,
                bn_stats: Optional[List] = None,
                remat: bool = False, group=None,
                return_features: bool = False,
                stop_after: Optional[str] = None,
                collect_amax: Optional[Dict[str, Tensor]] = None) -> Tensor:
        """x: (B, T, C, H, W), or (B, Hp, Wp, T*C) zero-padded with the PM
        channels raw when ``cfg.nhwc_input``; timestamps: (B, T', 4) raw
        (year, month, day, hour) rows.  Returns (B, L, H, W) f32 fields:
        the regression head's, or with ``cfg.pm25_class_head`` class 0's
        logit de-standardized, as ``metnet3_apply`` reads it.

        ``return_features``: return the (B*L, ch, H, W) features the heads
        read instead.  ``stop_after`` ("input" | "stem" | "vit_mbconv" |
        "vit_block" | "vit" | "resnet2"): return the partial pipeline
        through that stage, NCHW where JAX's is NHWC.  ``collect_amax``
        (a dict): record each resnet ``Block`` conv's max-|input| by site
        (calibration, ``ops/quantize.py``).  With ``cfg.int8_convs``, an
        eval forward takes each ``Block``'s int8 sidecar where it has one.

        In training mode, ``bn_stats`` (a list) receives each MBConv
        batch-norm's updated running statistics as ``(bn, mean, var)``, and
        with ``cfg.dropout > 0`` each attention call's dropout seed is drawn
        from ``generator``, before the backbone, so that ``remat``
        (``torch.utils.checkpoint`` over the backbone) recomputes the same
        masks.

        With a process ``group``, ``x`` is this rank's B rows of a global
        batch of B * world rows, rows rank * B .. (rank + 1) * B - 1, and
        ``timestamps`` is the global batch's (B * world, T', 4); every rank
        draws the same seeds from its generator and offsets them by
        ``rank_seed``."""
        cfg = self.cfg
        if not (cfg.pm25 or return_features or stop_after):
            raise ValueError("MetNet3 without pm25 has no regression head: "
                             "ask for return_features or class_outputs")
        with annotate("metnet3.forward"):
            out = self._features(x, timestamps, generator, bn_stats, remat,
                                 group, stop_after, collect_amax)
            if stop_after or return_features:
                return out
            with annotate("metnet3.head"):
                head = self.classifier_pm25
                preds = vnn.conv2d(out, head.weight, head.bias)
                preds = preds[:, 0].reshape(
                    x.shape[0], cfg.end_lead_time, *out.shape[-2:]).float()
                if cfg.normalization_method == "Standard":
                    preds = preds * cfg.pm25_std + cfg.pm25_mean
                return preds

    def _features(self, x: Tensor, timestamps: Tensor,
                  generator: Optional[torch.Generator],
                  bn_stats: Optional[List], remat: bool, group,
                  stop_after: Optional[str],
                  collect_amax: Optional[Dict[str, Tensor]]) -> Tensor:
        """``forward`` up to the heads, a span a stage: the (B*L, ch, H, W)
        features the heads read, or the partial pipeline through
        ``stop_after``."""
        cfg = self.cfg
        with annotate("metnet3.input"):
            rank = distributed.rank(group)
            seeds = None
            if self.training:
                if bn_stats is None:
                    raise ValueError("a training forward needs a bn_stats "
                                     "list")
                if cfg.dropout > 0.0:
                    if generator is None:
                        raise ValueError("a training forward with dropout "
                                         "needs a torch.Generator")
                    seeds = [rank_seed(s, rank) for s in torch.randint(
                        0, 2 ** 31 - 1, (2 * sum(cfg.depth_tuple),),
                        generator=generator).tolist()]
            B = x.shape[0]
            L = cfg.end_lead_time
            dtype = self.up.weight.dtype

            lead_times = torch.arange(1, L + 1, device=x.device).repeat(B)
            cond = self.condition_lead_time(lead_times)

            if cfg.nhwc_input:
                H, Wd = cfg.input_height, cfg.input_width
                pv = pad_values(H, Wd, cfg.pad_multiple)
                l, r, t, b = pv
                expect = (H + t + b, Wd + l + r,
                          cfg.window_size * cfg.n_variables)
                if tuple(x.shape[1:]) != expect:
                    raise ValueError(f"nhwc_input expects (B,{expect[0]},"
                                     f"{expect[1]},{expect[2]}), got "
                                     f"{tuple(x.shape)}")
                x = standardize_pm_channels_nhwc(x.to(dtype), cfg, pv)
                x = x.permute(0, 3, 1, 2)                  # channels_last NCHW
            else:
                _, T, C, H, Wd = x.shape
                x = standardize_pm_channels(x, cfg).reshape(B, T * C, H, Wd)
                x, pv = pad_hw(x, cfg.pad_multiple)
                x = x.contiguous(memory_format=torch.channels_last)
            hp, wp = x.shape[-2:]

            time_feats = None
            if cfg.concat_time_to_input:
                # over the global batch: its rows mix across the batch
                Bg = timestamps.shape[0]
                if Bg != B * distributed.world_size(group):
                    raise ValueError(f"timestamps hold {Bg} rows for {B} "
                                     "rows of x on each rank")
                row = min(6, timestamps.shape[1] - 1)
                ts6 = timestamps[:, row, :].repeat_interleave(L, dim=0)
                leads = torch.arange(1, L + 1, device=x.device).repeat(Bg)
                ts6 = torch.cat([ts6, leads[:, None].to(ts6.dtype)], dim=-1)
                time_feats = self._condition_time(ts6, Bg * L)
                time_feats = time_feats[rank * B * L:(rank + 1) * B * L]

            x = x.to(dtype)
            cond = cond.to(dtype)
            if stop_after == "input":
                return x
        int8 = cfg.int8_convs and not self.training
        with annotate("metnet3.stem"):
            if cfg.fuse_lead_stem and time_feats is not None:
                out = self._fused_lead_stem(x, time_feats.to(dtype), cond, L,
                                            int8, collect_amax)
            else:
                x = x.repeat_interleave(L, dim=0)
                if time_feats is not None:
                    maps = time_feats[:, :, None, None].expand(-1, -1, hp, wp)
                    x = torch.cat([x, maps.to(x.dtype)], dim=1)
                out = self.resnet1(x, cond, int8=int8,
                                   collect_amax=collect_amax, site="resnet1")
            out = vnn.max_pool_2x(out)
            if stop_after == "stem":
                return out
        vit_stop = {"vit_mbconv": "mbconv",
                    "vit_block": "block"}.get(stop_after)
        with annotate("metnet3.vit"):
            if not self.training:
                out = self.vit(out, cond, stop_after=vit_stop)
            elif remat:
                bns = []
                # the recompute runs in the backward, after a
                # functional_call (bf16 over f32 masters) has put the
                # masters back: it gets the parameters this forward sees
                vit_params = dict(self.vit.named_parameters())

                def backbone(h, c):
                    stats = []
                    y = functional_call(self.vit, vit_params, (h, c),
                                        dict(seeds=seeds, bn_stats=stats,
                                             group=group,
                                             stop_after=vit_stop))
                    bns[:] = [bn for bn, _, _ in stats]
                    return (y, *[t for _, m, v in stats for t in (m, v)])

                out, *flat = checkpoint(backbone, out, cond,
                                        use_reentrant=False)
                bn_stats.extend(zip(bns, flat[0::2], flat[1::2]))
            else:
                out = self.vit(out, cond, seeds=seeds, bn_stats=bn_stats,
                               group=group, stop_after=vit_stop)
            if stop_after in ("vit_mbconv", "vit_block", "vit"):
                return out
        with annotate("metnet3.up"):
            out = vnn.conv2d_transpose(out, self.up.weight, self.up.bias,
                                       stride=2)
        with annotate("metnet3.resnet2"):
            out = self.resnet2(out, cond, int8=int8,
                               collect_amax=collect_amax, site="resnet2")
            return unpad_hw(out, pv)

    def class_outputs(self, x: Tensor, timestamps: Tensor, *,
                      labels_pm25: Optional[Tensor] = None,
                      region_targets_pm25: Optional[Tensor] = None,
                      labels_pm10: Optional[Tensor] = None,
                      region_targets_pm10: Optional[Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      bn_stats: Optional[List] = None) -> dict:
        """The class-head training contract, the counterpart of
        ``metnet3_class_outputs``: per-cell class logits (B*L, n, H, W),
        the bucketized cross-entropy against ``labels_*`` (B*L, H, W) with
        NaN targets masked, midpoint-decoded ``predicted_*`` values, the
        regional heads' (B*L, 19) ``region_preds_*`` and their MSE against
        ``region_targets_*`` (they read detached features under
        ``cfg.ignore_backbone``), and ``loss``, the sum of the losses
        given.  Training mode takes ``generator`` and ``bn_stats`` as
        ``forward`` does.  f32 only: the JAX function cannot run in bf16
        (its heads read the uncast f32 weights), so bf16 raises."""
        cfg = self.cfg
        if (cfg.compute_dtype != "float32"
                or self.up.weight.dtype != torch.float32):
            raise ValueError("MetNet3.class_outputs runs in float32 only, "
                             "as metnet3_class_outputs does")
        ret = {}

        def head(suffix, labels, region_targets):           # reads feats
            conv = getattr(self, f"classifier_{suffix}")
            bounds = getattr(self, f"{suffix}_boundaries")
            logits = vnn.conv2d(feats, conv.weight, conv.bias)
            ret[f"logits_{suffix}"] = logits
            loss = 0.0
            if labels is not None:
                loss = L.pm_class_cross_entropy(logits, labels, bounds)
                ret[f"loss_{suffix}"] = loss
            ret[f"predicted_{suffix}"] = categorical_to_continuous(
                logits.argmax(dim=1), bounds)
            regr_loss = 0.0
            regional = getattr(self, f"regr_regional_{suffix}", None)
            if regional is not None:
                src = feats.detach() if cfg.ignore_backbone else feats
                r = vnn.conv2d(src, regional[0].weight, regional[0].bias)
                r = vnn.linear(r.reshape(r.shape[0], -1), regional[2].weight,
                               regional[2].bias)
                ret[f"region_preds_{suffix}"] = r
                if region_targets is not None:
                    regr_loss = L.regional_mse_loss(r, region_targets)
                    ret[f"regr_loss_{suffix}"] = regr_loss
            return loss + regr_loss

        with annotate("metnet3.class_outputs"):
            feats = self._features(x, timestamps, generator, bn_stats, False,
                                   None, None, None)
            with annotate("metnet3.head"):
                total = 0.0
                if cfg.pm25 and cfg.pm25_class_head:
                    total = total + head("pm25", labels_pm25,
                                         region_targets_pm25)
                if cfg.pm10:
                    total = total + head("pm10", labels_pm10,
                                         region_targets_pm10)
                ret["loss"] = total
        return ret


def get_ignore_keys_for_eval(cfg: MetNet3Config) -> list:
    """Output keys to drop at evaluation, as the JAX package's
    ``get_ignore_keys_for_eval``."""
    keys = []
    if cfg.pm25:
        keys += ["loss_pm25", "logits_pm25"]
        if cfg.direct_regional:
            keys += ["regr_loss_pm25"]
    if cfg.pm10:
        keys += ["loss_pm10", "logits_pm10"]
        if cfg.direct_regional:
            keys += ["regr_loss_pm10"]
    return keys
