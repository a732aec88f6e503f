"""MBConv inverted-bottleneck block.

Counterpart of ``vit_grid_model_tpu/ops/mbconv.py``: 1x1 expand -> BN ->
GELU -> depthwise 3x3 -> BN -> GELU -> squeeze-excite -> 1x1 project -> BN,
with a residual only when ``dim_in == dim_out and not downsample``.  The
hidden width is ``expansion_rate * dim_out`` and the block never changes
the spatial size.  Given a ``bn_stats`` list, the block runs in training
mode: batch statistics (over the global batch of a process ``group``),
with each BatchNorm's updated running statistics appended as ``(bn, mean,
var)``.  Without one,
``fold_bn`` folds each BatchNorm into its conv (``mbconv(fold_bn=True)``,
inference only).  Its dropout stays 0, as ``maxvit.py`` runs it.  These
run on stock ops (cuDNN), as the JAX package leaves MBConv to XLA.

The layers sit at the reference's Sequential indices (0, 1, 3, 4, 6, 7, 8),
and a residual block nests them under ``fn.``, so the state_dict keys are
those of ``core/export.py::_emit_mbconv``.

``fused_mbconv_reference`` is the plain version of the fused MBConv of
``benchmarks/mosaic_repros/repro_fused_mbconv.py`` (R15), whose CUDA kernel
is ``ops/cuda/mbconv.py::fused_mbconv``; ``mbconv_kernel_operands`` turns a
block into its operands.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from vit_grid_model_tpu_torch.ops import nn as vnn


class MBConv(nn.Sequential):
    def __init__(self, dim_in: int, dim_out: int, *, expansion_rate: int = 4,
                 shrinkage_rate: float = 0.25):
        hidden = int(expansion_rate * dim_out)
        super().__init__(
            nn.Conv2d(dim_in, hidden, 1), nn.BatchNorm2d(hidden), nn.GELU(),
            nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden),
            nn.BatchNorm2d(hidden), nn.GELU(),
            vnn.SqueezeExcite(hidden, shrinkage_rate),
            nn.Conv2d(hidden, dim_out, 1), nn.BatchNorm2d(dim_out))

    def forward(self, x: Tensor, bn_stats: Optional[List] = None,
                fold_bn: bool = False, group=None) -> Tensor:
        expand, bn1, _, dw, bn2, _, se, project, bn3 = self
        if fold_bn and bn_stats is None:
            h = vnn.conv2d(x, *vnn.fold_bn_into_conv(expand.weight,
                                                      expand.bias, bn1))
            h = vnn.gelu(h)
            h = vnn.conv2d(h, *vnn.fold_bn_into_conv(dw.weight, dw.bias, bn2),
                           padding=1, groups=dw.groups)
            h = se(vnn.gelu(h))
            return vnn.conv2d(h, *vnn.fold_bn_into_conv(project.weight,
                                                         project.bias, bn3))

        def norm(h, bn):
            if bn_stats is None:
                return vnn.batch_norm(h, bn)
            h, mean, var = vnn.batch_norm_train(h, bn, group=group)
            bn_stats.append((bn, mean, var))
            return h

        h = vnn.conv2d(x, expand.weight, expand.bias)
        h = vnn.gelu(norm(h, bn1))
        h = vnn.conv2d(h, dw.weight, dw.bias, padding=1, groups=dw.groups)
        h = vnn.gelu(norm(h, bn2))
        h = se(h)
        h = vnn.conv2d(h, project.weight, project.bias)
        return norm(h, bn3)


class MBConvResidual(nn.Module):
    def __init__(self, dim: int, **kw):
        super().__init__()
        self.fn = MBConv(dim, dim, **kw)

    def forward(self, x: Tensor, bn_stats: Optional[List] = None,
                fold_bn: bool = False, group=None) -> Tensor:
        return self.fn(x, bn_stats, fold_bn, group) + x


def mbconv(dim_in: int, dim_out: int, *, downsample: bool,
           expansion_rate: int = 4, shrinkage_rate: float = 0.25) -> nn.Module:
    """The block for one MaxViT layer, with the residual rule applied."""
    kw = dict(expansion_rate=expansion_rate, shrinkage_rate=shrinkage_rate)
    if dim_in == dim_out and not downsample:
        return MBConvResidual(dim_out, **kw)
    return MBConv(dim_in, dim_out, **kw)


# ---------------------------------------------------------------------------
# the fused MBConv of R15: operands and plain version
# ---------------------------------------------------------------------------

#: (we, be, wd, bd, w1, b1, w2, b2, wp, bp): expand (C, HID) and bias,
#: depthwise taps (3, 3, HID) and bias, SE (HID, SE) + bias and (SE, HID) +
#: bias, project (HID, C) and bias; f32, the BatchNorms folded in
Operands = Tuple[Tensor, ...]


def mbconv_kernel_operands(block: nn.Module) -> Operands:
    """A block of ``mbconv`` -> the fused kernel's operands, its
    BatchNorms folded in (eval mode).  The model's SE linears have no
    biases, so b1 and b2 are zero.  The fused MBConv always adds its input,
    so for a block without a residual it computes ``block(x) + x``."""
    m = block.fn if isinstance(block, MBConvResidual) else block
    expand, bn1, _, dw, bn2, _, se, project, bn3 = m
    with torch.no_grad():
        we, be = vnn.fold_bn_into_conv(expand.weight, expand.bias, bn1)
        wd, bd = vnn.fold_bn_into_conv(dw.weight, dw.bias, bn2)
        wp, bp = vnn.fold_bn_into_conv(project.weight, project.bias, bn3)
        w1, w2 = se.gate[1].weight, se.gate[3].weight     # (SE, HID), (HID, SE)
        ops = (we[:, :, 0, 0].t(), be, wd[:, 0].permute(1, 2, 0), bd, w1.t(),
               torch.zeros_like(w1[:, 0]), w2.t(), torch.zeros_like(w2[:, 0]),
               wp[:, :, 0, 0].t(), bp)
        return tuple(t.float().contiguous() for t in ops)


def fused_mbconv_reference(x: Tensor, ops: Operands) -> Tensor:
    """The plain version of the fused MBConv on NHWC ``x`` (N, H, W, C):

        h1 = gelu(x . we + be)
        h2 = gelu(dw3x3(h1) + bd)                       SAME zero padding
        g  = sigmoid(relu(mean_HW(h2) . w1 + b1) . w2 + b2)
        y  = (h2 * g) . wp + bp + x

    with the cast points of ``repro_fused_mbconv.py::xla_reference``: every
    product takes operands rounded to x's dtype and sums in f32, and h1,
    mean(h2), the SE hidden and h2 * g are rounded to x's dtype before the
    product that reads them.  Returns x's dtype."""
    we, be, wd, bd, w1, b1, w2, b2, wp, bp = ops
    dt = x.dtype

    def r(t):
        """Round to x's dtype, compute on in f32."""
        return t.to(dt).float()

    xf = x.float()
    h1 = vnn.gelu(xf @ r(we) + be)
    taps = r(wd).permute(2, 0, 1)[:, None]                 # (HID, 1, 3, 3)
    h2 = F.conv2d(r(h1).permute(0, 3, 1, 2), taps, padding=1,
                  groups=taps.shape[0]).permute(0, 2, 3, 1)
    h2 = vnn.gelu(h2 + bd)
    g = torch.relu(r(h2.mean(dim=(1, 2))) @ r(w1) + b1)
    g = torch.sigmoid(r(g) @ r(w2) + b2)
    y = r(h2 * g[:, None, None, :]) @ r(wp) + bp
    return (y + xf).to(dt)
