"""The plain reference of the MaxViT MetNet3 grid model: float32 PyTorch,
written from the published computation, with no kernel, no fusion and no
import of the program under test.

The parameters are a flat dict keyed by the state_dict names of the
published checkpoint (``param_table``).  The computation, in order:

* the PM2.5 cycle channels of x (B, T, C, H, W) are standardized with the
  global mean/std; the (T*C) planes are zero-padded, centered, to a
  multiple of ``pad_multiple``;
* each sample is repeated L times (sample-major) with leads 1..L; the
  lead embedding is the resnet blocks' condition, and the time features
  (lead embedding ++ month/day/hour embeddings of timestamps row 6, the
  three (B*L, 1) lookups concatenated along rows and viewed per row, which
  mixes rows across the batch) are broadcast as constant planes and
  concatenated to the input;
* resnet blocks (conv3x3 -> channel LayerNorm with rsqrt(max(var, eps)) ->
  (scale + 1, shift) from the condition -> ReLU, twice, plus a 1x1 or
  identity residual), 2x2 max-pool;
* per MaxViT layer: MBConv (1x1 expand, BN, GELU, depthwise 3x3, BN, GELU,
  squeeze-excite, 1x1 project, BN; a residual unless it is a stage's first
  layer), block attention and grid attention over 7x7 windows with 4
  register tokens each (registers averaged over a sample's windows between
  the two), FiLM on an unaffine LayerNorm, QK-RMSNorm (l2 norm times
  sqrt(dh) times gamma), the relative-position bias (registers read the
  table's last row), softmax, attention dropout by the counter-hash mask
  in training, and a residual that includes the registers;
* 2x2 transposed conv, resnet blocks, unpad, 1x1 head, de-standardize.

Every product (convolution, linear, batched matmul) takes its operands
through ``Precision.operand`` so that the control can run the same
computation in a lower precision.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from gridbench.reference.dropout import keep_mask

Params = Dict[str, Tensor]


class Precision:
    """The arithmetic of the products: float32 operands by default.
    ``Fp8`` rounds every operand (and, in the backward, every incoming
    gradient) to 8-bit floats."""

    def operand(self, t: Tensor) -> Tensor:
        return t


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def layer_dims(dim: int, depth: Sequence[int]) -> List[Tuple[int, int, bool]]:
    """(dim_in, dim_out, first of its stage) of each MaxViT layer."""
    dims = tuple((2 ** i) * dim for i in range(len(depth)))
    pairs = (tuple(zip(dims[:-1], dims[1:])) if len(depth) > 1
             else ((dim, dim),))
    out = []
    for (stage_in, stage_dim), stage_depth in zip(pairs, depth):
        for i in range(stage_depth):
            out.append((stage_in if i == 0 else stage_dim, stage_dim, i == 0))
    return out


def _depth(cfg: dict) -> Tuple[int, ...]:
    d = cfg["vit_block_depth"]
    return (d,) if isinstance(d, int) else tuple(d)


Table = "OrderedDict[str, Tuple[Tuple[int, ...], str, int]]"


def param_table(cfg: dict) -> Table:
    """name -> (shape, kind, fan_in) of every state_dict entry.  kind is
    "weight" or "bias" (fan-in uniform), "embedding" (standard normal),
    "gain" (near 1), "shift" (near 0), "running_mean", "running_var",
    "count" (int64 0) or "boundaries" (the class boundaries)."""
    for key, implemented in (("concat_time_to_input", True), ("pm25", True),
                             ("pm10", False), ("pm25_class_head", False),
                             ("direct_regional", False)):
        if cfg.get(key, implemented) != implemented:
            raise ValueError(f"the reference implements {key}={implemented}")
    t: Table = OrderedDict()
    ch = cfg["n_start_channels"]
    emb = cfg["model_time_emb_dim"]
    lead = cfg["lead_time_emb_dim"]
    n_in = cfg["window_size"] * cfg["n_variables"] + lead + 3 * emb
    t["pm25_boundaries"] = ((len(cfg["pm25_boundaries"]),), "boundaries", 0)
    t["condition_lead_time.weight"] = ((cfg["end_lead_time"] + 1, lead),
                                       "embedding", 0)
    for i, rows in enumerate((13, 32, 25)):
        t[f"condition_model_time.{i}.weight"] = ((rows, emb), "embedding", 0)

    def conv(name, cout, cin, k, groups=1):
        fan = cin // groups * k * k
        t[f"{name}.weight"] = ((cout, cin // groups, k, k), "weight", fan)
        t[f"{name}.bias"] = ((cout,), "bias", fan)

    def resnet(prefix, cin, cout):
        for i in range(cfg["resnet_block_depth"]):
            p = f"{prefix}.blocks.{i}"
            d_in = cin if i == 0 else cout
            conv(f"{p}.block1.proj", cout, d_in, 3)
            t[f"{p}.block1.norm.g"] = ((1, cout, 1, 1), "gain", 0)
            t[f"{p}.block1.norm.b"] = ((1, cout, 1, 1), "shift", 0)
            conv(f"{p}.block2.proj", cout, cout, 3)
            t[f"{p}.block2.norm.g"] = ((1, cout, 1, 1), "gain", 0)
            t[f"{p}.block2.norm.b"] = ((1, cout, 1, 1), "shift", 0)
            t[f"{p}.mlp.1.weight"] = ((2 * cout, lead), "weight", lead)
            t[f"{p}.mlp.1.bias"] = ((2 * cout,), "bias", lead)
            if d_in != cout:
                conv(f"{p}.res_conv", cout, d_in, 1)

    def bn(name, c):
        t[f"{name}.weight"] = ((c,), "gain", 0)
        t[f"{name}.bias"] = ((c,), "shift", 0)
        t[f"{name}.running_mean"] = ((c,), "running_mean", 0)
        t[f"{name}.running_var"] = ((c,), "running_var", 0)
        t[f"{name}.num_batches_tracked"] = ((), "count", 0)

    resnet("resnet1", n_in, ch)
    heads, dh = cfg["n_heads"], cfg["dim_head"]
    inner = heads * dh
    w = cfg["vit_window_size"]
    for li, (d_in, d_out, first) in enumerate(layer_dims(ch, _depth(cfg))):
        hid = int(cfg["mbconv_expansion_rate"] * d_out)
        se = int(hid * cfg["mbconv_shrinkage_rate"])
        m = f"vit.layers.{li}.0" + ("" if (d_in != d_out or first) else ".fn")
        conv(f"{m}.0", hid, d_in, 1)
        bn(f"{m}.1", hid)
        conv(f"{m}.3", hid, hid, 3, groups=hid)
        bn(f"{m}.4", hid)
        t[f"{m}.6.gate.1.weight"] = ((se, hid), "weight", hid)
        t[f"{m}.6.gate.3.weight"] = ((hid, se), "weight", se)
        conv(f"{m}.7", d_out, hid, 1)
        bn(f"{m}.8", d_out)
        for a in (1, 2):
            p = f"vit.layers.{li}.{a}"
            t[f"{p}.film.0.weight"] = ((2 * d_out, lead), "weight", lead)
            t[f"{p}.film.0.bias"] = ((2 * d_out,), "bias", lead)
            t[f"{p}.film.2.weight"] = ((2 * d_out, 2 * d_out), "weight",
                                       2 * d_out)
            t[f"{p}.film.2.bias"] = ((2 * d_out,), "bias", 2 * d_out)
            t[f"{p}.to_qkv.weight"] = ((3 * inner, d_out), "weight", d_out)
            t[f"{p}.q_norm.gamma"] = ((heads, 1, dh), "gain", 0)
            t[f"{p}.k_norm.gamma"] = ((heads, 1, dh), "gain", 0)
            t[f"{p}.to_out.0.weight"] = ((d_out, inner), "weight", inner)
            t[f"{p}.rel_pos_bias.weight"] = (((2 * w - 1) ** 2 + 1, heads),
                                             "embedding", 0)
    for li, (_, d_out, _) in enumerate(layer_dims(ch, _depth(cfg))):
        t[f"vit.register_tokens.{li}"] = ((cfg["num_register_tokens"], d_out),
                                          "embedding", 0)
    t["up.weight"] = ((ch, ch, 2, 2), "weight", ch * 4)
    t["up.bias"] = ((ch,), "bias", ch * 4)
    resnet("resnet2", ch, ch)
    conv("classifier_pm25", 1, ch, 1)
    return t


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


class _Ops:
    def __init__(self, prec: Precision):
        self.q = prec.operand

    def conv(self, x, w, b=None, padding=0, groups=1):
        return F.conv2d(self.q(x), self.q(w), b, padding=padding,
                        groups=groups)

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))


def _chan_layer_norm(x, g, b, eps=1e-5):
    mean = x.mean(dim=1, keepdim=True)
    var = (x - mean).square().mean(dim=1, keepdim=True)
    return (x - mean) * torch.rsqrt(var.clamp(min=eps)) * g + b


def _resnet(P: Params, ops: _Ops, prefix: str, depth: int, x: Tensor,
            cond: Tensor) -> Tensor:
    for i in range(depth):
        p = f"{prefix}.blocks.{i}"
        c = ops.linear(torch.relu(cond), P[f"{p}.mlp.1.weight"],
                       P[f"{p}.mlp.1.bias"])
        scale, shift = c.chunk(2, dim=-1)
        h = ops.conv(x, P[f"{p}.block1.proj.weight"],
                     P[f"{p}.block1.proj.bias"], padding=1)
        h = _chan_layer_norm(h, P[f"{p}.block1.norm.g"],
                             P[f"{p}.block1.norm.b"])
        h = torch.relu(h * (scale[:, :, None, None] + 1.0)
                       + shift[:, :, None, None])
        h = ops.conv(h, P[f"{p}.block2.proj.weight"],
                     P[f"{p}.block2.proj.bias"], padding=1)
        h = torch.relu(_chan_layer_norm(h, P[f"{p}.block2.norm.g"],
                                        P[f"{p}.block2.norm.b"]))
        if f"{p}.res_conv.weight" in P:
            x = ops.conv(x, P[f"{p}.res_conv.weight"], P[f"{p}.res_conv.bias"])
        x = h + x
    return x


def _batch_norm(P: Params, name: str, x: Tensor,
                stats: Optional[Dict[str, Tensor]]) -> Tensor:
    """Eval: the running statistics.  Training (``stats`` a dict): the
    biased batch statistics, and the momentum-0.1 running update with the
    unbiased variance recorded into ``stats``."""
    shape = (1, -1, 1, 1)
    w, b = P[f"{name}.weight"].view(shape), P[f"{name}.bias"].view(shape)
    if stats is None:
        mean = P[f"{name}.running_mean"].view(shape)
        var = P[f"{name}.running_var"].view(shape)
        return (x - mean) * torch.rsqrt(var + 1e-5) * w + b
    mean = x.mean(dim=(0, 2, 3))
    var = (x - mean.view(shape)).square().mean(dim=(0, 2, 3))
    count = x.numel() // x.shape[1]
    with torch.no_grad():
        stats[f"{name}.running_mean"] = (
            0.9 * P[f"{name}.running_mean"] + 0.1 * mean.detach())
        stats[f"{name}.running_var"] = (
            0.9 * P[f"{name}.running_var"]
            + 0.1 * var.detach() * (count / max(count - 1, 1)))
    return (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + 1e-5) * w + b


def _mbconv(P: Params, ops: _Ops, m: str, x: Tensor,
            stats: Optional[Dict[str, Tensor]]) -> Tensor:
    h = ops.conv(x, P[f"{m}.0.weight"], P[f"{m}.0.bias"])
    h = F.gelu(_batch_norm(P, f"{m}.1", h, stats))
    hid = h.shape[1]
    h = ops.conv(h, P[f"{m}.3.weight"], P[f"{m}.3.bias"], padding=1,
                 groups=hid)
    h = F.gelu(_batch_norm(P, f"{m}.4", h, stats))
    g = torch.relu(ops.linear(h.mean(dim=(2, 3)), P[f"{m}.6.gate.1.weight"]))
    g = torch.sigmoid(ops.linear(g, P[f"{m}.6.gate.3.weight"]))
    h = h * g[:, :, None, None]
    h = ops.conv(h, P[f"{m}.7.weight"], P[f"{m}.7.bias"])
    return _batch_norm(P, f"{m}.8", h, stats)


def bias_indices(w: int, nr: int, device=None) -> Tensor:
    """(n, n) rows of the relative-position table for registers ++ window
    tokens; register rows and columns read the last row, (2w-1)^2."""
    pos = torch.arange(w, device=device)
    gy, gx = torch.meshgrid(pos, pos, indexing="ij")
    grid = torch.stack([gy.reshape(-1), gx.reshape(-1)], dim=-1)
    rel = grid[:, None, :] - grid[None, :, :] + (w - 1)
    idx = rel[..., 0] * (2 * w - 1) + rel[..., 1]
    n = w * w + nr
    full = torch.full((n, n), (2 * w - 1) ** 2, dtype=torch.int64,
                      device=device)
    full[nr:, nr:] = idx
    return full


def _attention(P: Params, ops: _Ops, p: str, cfg: dict, x: Tensor,
               cond: Tensor, wps: int, seed: Optional[int]) -> Tensor:
    """x (Bw, n, d) window tokens, sample-major; cond (Bw / wps, cond);
    ``seed``: training dropout at cfg["dropout"], windows numbered from 0
    in the call."""
    bw, n, d = x.shape
    heads, dh = cfg["n_heads"], cfg["dim_head"]
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + 1e-5)
    h = ops.linear(cond, P[f"{p}.film.0.weight"], P[f"{p}.film.0.bias"])
    h = ops.linear(F.silu(h), P[f"{p}.film.2.weight"], P[f"{p}.film.2.bias"])
    gamma, beta = h.chunk(2, dim=-1)
    x = (x * gamma.repeat_interleave(wps, dim=0)[:, None]
         + beta.repeat_interleave(wps, dim=0)[:, None])
    q, k, v = ops.linear(x, P[f"{p}.to_qkv.weight"]).chunk(3, dim=-1)

    def heads_first(t):
        return t.reshape(bw, n, heads, dh).transpose(1, 2)

    def rms(t, g):
        norm = t.square().sum(dim=-1, keepdim=True).sqrt()
        return t / norm.clamp(min=1e-12) * math.sqrt(dh) * g

    q = rms(heads_first(q), P[f"{p}.q_norm.gamma"])
    k = rms(heads_first(k), P[f"{p}.k_norm.gamma"])
    v = heads_first(v)
    idx = bias_indices(cfg["vit_window_size"], cfg["num_register_tokens"],
                       x.device)
    bias = P[f"{p}.rel_pos_bias.weight"][idx].permute(2, 0, 1)
    attn = (ops.matmul(q, k.transpose(-1, -2)) + bias).softmax(dim=-1)
    if seed is not None:
        attn = attn * keep_mask(seed, bw, heads, n, cfg["dropout"],
                                device=x.device)
    out = ops.matmul(attn, v).transpose(1, 2).reshape(bw, n, heads * dh)
    return ops.linear(out, P[f"{p}.to_out.0.weight"])


def _maxvit(P: Params, ops: _Ops, cfg: dict, x: Tensor, cond: Tensor,
            seeds: Optional[Sequence[int]],
            stats: Optional[Dict[str, Tensor]]) -> Tensor:
    w, nr = cfg["vit_window_size"], cfg["num_register_tokens"]
    dims = layer_dims(cfg["n_start_channels"], _depth(cfg))
    for li, (d_in, d_out, first) in enumerate(dims):
        residual = d_in == d_out and not first
        m = f"vit.layers.{li}.0" + (".fn" if residual else "")
        y = _mbconv(P, ops, m, x, stats)
        x = y + x if residual else y
        b, d, hh, ww = x.shape
        nx, ny = hh // w, ww // w
        nwin = nx * ny
        x = x.permute(0, 2, 3, 1)
        # block attention: local windows
        xw = (x.reshape(b, nx, w, ny, w, d).permute(0, 1, 3, 2, 4, 5)
              .reshape(b * nwin, w * w, d))
        r = P[f"vit.register_tokens.{li}"].expand(b * nwin, nr, d)
        tok = torch.cat([r, xw], dim=1)
        seed = None if seeds is None else seeds[2 * li]
        tok = _attention(P, ops, f"vit.layers.{li}.1", cfg, tok, cond, nwin,
                         seed) + tok
        r, xw = tok[:, :nr], tok[:, nr:]
        x = (xw.reshape(b, nx, ny, w, w, d).permute(0, 1, 3, 2, 4, 5)
             .reshape(b, hh, ww, d))
        # grid attention: strided windows, registers averaged per sample
        r = r.reshape(b, nwin, nr, d).mean(dim=1).repeat_interleave(nwin, 0)
        xw = (x.reshape(b, w, nx, w, ny, d).permute(0, 2, 4, 1, 3, 5)
              .reshape(b * nwin, w * w, d))
        tok = torch.cat([r, xw], dim=1)
        seed = None if seeds is None else seeds[2 * li + 1]
        tok = _attention(P, ops, f"vit.layers.{li}.2", cfg, tok, cond, nwin,
                         seed) + tok
        xw = tok[:, nr:]
        x = (xw.reshape(b, nx, ny, w, w, d).permute(0, 3, 1, 4, 2, 5)
             .reshape(b, hh, ww, d).permute(0, 3, 1, 2))
    return x


def pad_values(h: int, w: int, multiple: int) -> Tuple[int, int, int, int]:
    """(left, right, top, bottom) centering (h, w) into the next multiple."""
    ph, pw = (multiple - h) % multiple, (multiple - w) % multiple
    return pw // 2, pw - pw // 2, ph // 2, ph - ph // 2


def forward(P: Params, cfg: dict, x: Tensor, ts: Tensor, *,
            seeds: Optional[Sequence[int]] = None,
            stats: Optional[Dict[str, Tensor]] = None,
            prec: Precision = Precision(),
            block: Optional[int] = None) -> Tensor:
    """x (B, T, C, H, W) f32, ts (B, T', 4) rows of (year, month, day,
    hour).  Returns the (B, L, H, W) PM2.5 fields.

    Training: ``stats`` (a dict) turns on batch-statistics BN and receives
    the running statistics it would write; ``seeds`` (two per MaxViT
    layer, block then grid) turns on attention dropout.  ``block``: run
    the samples in blocks of this many (eval only; the time features are
    still taken over the whole batch, whose rows they mix)."""
    ops = _Ops(prec)
    B, T, C, H, W = x.shape
    L = cfg["end_lead_time"]
    x = x.float()
    if cfg["normalization_method"] == "Standard":
        idx = list(cfg["pm25_channel_indices"])
        if cfg.get("stn_img_channel") is not None:
            idx.append(cfg["stn_img_channel"])
        x = x.clone()
        x[:, :, idx] = (x[:, :, idx] - cfg["pm25_mean"]) / cfg["pm25_std"]
    pv = pad_values(H, W, cfg["pad_multiple"])
    x = F.pad(x.reshape(B, T * C, H, W), pv)

    leads = torch.arange(1, L + 1, device=x.device).repeat(B)
    lead_table = P["condition_lead_time.weight"]
    cond = lead_table[leads]
    row = min(6, ts.shape[1] - 1)
    when = ts[:, row, :].repeat_interleave(L, dim=0).long()
    embs = [P[f"condition_model_time.{i}.weight"][when[:, 1 + i]]
            for i in range(3)]
    scrambled = torch.cat(embs, dim=0).reshape(B * L, -1)
    time_feats = torch.cat([cond, scrambled], dim=-1)

    if stats is not None and block is not None:
        raise ValueError("a training forward runs the whole batch at once")
    step = B if block is None else block
    outs = []
    for s in range(0, B, step):
        e = min(B, s + step)
        xs = x[s:e].repeat_interleave(L, dim=0)
        tf = time_feats[s * L:e * L]
        c = cond[s * L:e * L]
        planes = tf[:, :, None, None].expand(-1, -1, *xs.shape[2:])
        xs = torch.cat([xs, planes], dim=1)
        h = _resnet(P, ops, "resnet1", cfg["resnet_block_depth"], xs, c)
        h = F.max_pool2d(h, 2)
        h = _maxvit(P, ops, cfg, h, c, seeds, stats)
        h = F.conv_transpose2d(ops.q(h), ops.q(P["up.weight"]), P["up.bias"],
                               stride=2)
        h = _resnet(P, ops, "resnet2", cfg["resnet_block_depth"], h, c)
        l, r, t, b = pv
        h = h[:, :, t:h.shape[2] - b, l:h.shape[3] - r]
        y = ops.conv(h, P["classifier_pm25.weight"], P["classifier_pm25.bias"])
        outs.append(y[:, 0].reshape(e - s, L, H, W))
    preds = torch.cat(outs) if len(outs) > 1 else outs[0]
    if cfg["normalization_method"] == "Standard":
        preds = preds * cfg["pm25_std"] + cfg["pm25_mean"]
    return preds
