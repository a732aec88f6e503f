"""MBConv inverted-bottleneck block, eval mode.

Counterpart of ``vit_grid_model_tpu/ops/mbconv.py``: 1x1 expand -> BN ->
GELU -> depthwise 3x3 -> BN -> GELU -> squeeze-excite -> 1x1 project -> BN,
with a residual only when ``dim_in == dim_out and not downsample``.  The
hidden width is ``expansion_rate * dim_out`` and the block never changes
the spatial size.

The layers sit at the reference's Sequential indices (0, 1, 3, 4, 6, 7, 8),
and a residual block nests them under ``fn.``, so the state_dict keys are
those of ``core/torch_export.py::_emit_mbconv``.
"""

from __future__ import annotations

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

    def forward(self, x: Tensor) -> Tensor:
        expand, bn1, _, dw, bn2, _, se, project, bn3 = self
        h = vnn.conv2d(x, expand.weight, expand.bias)
        h = vnn.gelu(vnn.batch_norm(h, bn1))
        h = vnn.conv2d(h, dw.weight, dw.bias, padding=1, groups=dw.groups)
        h = vnn.gelu(vnn.batch_norm(h, bn2))
        h = se(h)
        h = vnn.conv2d(h, project.weight, project.bias)
        return vnn.batch_norm(h, bn3)


class MBConvResidual(nn.Module):
    def __init__(self, dim: int, **kw):
        super().__init__()
        self.fn = MBConv(dim, dim, **kw)

    def forward(self, x: Tensor) -> Tensor:
        return self.fn(x) + x


def mbconv(dim_in: int, dim_out: int, *, downsample: bool,
           expansion_rate: int = 4, shrinkage_rate: float = 0.25) -> nn.Module:
    """The block for one MaxViT layer, with the residual rule applied."""
    kw = dict(expansion_rate=expansion_rate, shrinkage_rate=shrinkage_rate)
    if dim_in == dim_out and not downsample:
        return MBConvResidual(dim_out, **kw)
    return MBConv(dim_in, dim_out, **kw)
