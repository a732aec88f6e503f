"""Neural-net primitives of the MetNet3 / MaxViT forward, in PyTorch.

Counterpart of ``vit_grid_model_tpu/ops/nn.py``.  Activations are NCHW here
(PyTorch's convolution layout) and weights keep PyTorch's own layouts
(``nn.Linear`` (out, in), ``nn.Conv2d`` OIHW, ``nn.ConvTranspose2d``
(in, out, kh, kw)), which are the layouts ``core/torch_export.py`` emits.
The recipes the JAX package pins are kept exactly:

* ``chan_layer_norm`` uses ``rsqrt(max(var, eps))``, not ``+eps``;
* ``layer_norm`` uses ``rsqrt(var + eps)`` and no affine when conditioned;
* ``qk_rms_norm`` is l2-normalize with a 1e-12 clamp, times sqrt(d) times
  gamma, with no ``dim_head ** -0.5``;
* ``gelu`` is the exact (erf) GELU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from vit_grid_model_tpu_torch.core import distributed

# ---------------------------------------------------------------------------
# dense / embedding / convolutions
# ---------------------------------------------------------------------------


def linear(x: Tensor, weight: Tensor, bias: Optional[Tensor] = None) -> Tensor:
    return F.linear(x, weight, bias)


def embedding(table: Tensor, idx: Tensor) -> Tensor:
    return F.embedding(idx, table)


def conv2d(x: Tensor, weight: Tensor, bias: Optional[Tensor] = None, *,
           padding: int = 0, groups: int = 1) -> Tensor:
    """Stride-1 NCHW convolution with symmetric zero padding."""
    return F.conv2d(x, weight, bias, padding=padding, groups=groups)


def conv2d_transpose(x: Tensor, weight: Tensor, bias: Optional[Tensor] = None,
                     *, stride: int = 2) -> Tensor:
    """Transposed conv with kernel == stride (the MetNet3 upsample); weight
    in ``nn.ConvTranspose2d``'s (in, out, kh, kw) layout."""
    return F.conv_transpose2d(x, weight, bias, stride=stride)


# ---------------------------------------------------------------------------
# normalizations
# ---------------------------------------------------------------------------


def batch_norm(x: Tensor, bn: nn.BatchNorm2d) -> Tensor:
    """Eval-mode BatchNorm over NCHW channels from the running statistics:
    ``(x - mean) * rsqrt(var + eps) * scale + bias``."""
    shape = (1, -1, 1, 1)
    inv = torch.rsqrt(bn.running_var + bn.eps)
    return ((x - bn.running_mean.view(shape)) * inv.view(shape)
            * bn.weight.view(shape) + bn.bias.view(shape))


def batch_norm_train(x: Tensor, bn: nn.BatchNorm2d, *,
                     momentum: float = 0.1,
                     group=None) -> Tuple[Tensor, Tensor, Tensor]:
    """Training-mode BatchNorm over NCHW channels, the counterpart of
    ``vit_grid_model_tpu/ops/nn.py::batch_norm(training=True)``.

    Normalizes with the biased batch variance and returns ``(y, mean,
    var)``: the updated running statistics, with momentum 0.1 and the
    unbiased variance n/(n-1), detached and in x's dtype.  They are not
    written here: the trainer writes them into the module's f32 buffers
    after the optimizer step, as ``trainer.py::_merge_bn`` does.

    With a process ``group``, ``x`` is this rank's share of the batch (equal
    shares): the mean and variance are taken over the global batch by a
    differentiable all-reduce of f32 sums, as the JAX package's batch
    statistics span the mesh, and n counts the global batch.  One process
    takes the same f32 sums without the all-reduce."""
    shape = (1, -1, 1, 1)
    dims = (0, 2, 3)
    count = x.numel() // x.shape[1] * distributed.world_size(group)

    def global_mean(t):
        s = t.sum(dim=dims, dtype=torch.float32)
        if group is not None:
            s = distributed.all_reduce_sum(s, group)
        return (s / count).to(x.dtype)

    mean = global_mean(x)
    var = global_mean((x - mean.view(shape)).square())
    y = ((x - mean.view(shape)) * torch.rsqrt(var + bn.eps).view(shape)
         * bn.weight.view(shape) + bn.bias.view(shape))
    with torch.no_grad():
        unbiased = var * (count / max(count - 1, 1))
        new_mean = ((1 - momentum) * bn.running_mean.to(x.dtype)
                    + momentum * mean)
        new_var = ((1 - momentum) * bn.running_var.to(x.dtype)
                   + momentum * unbiased)
    return y, new_mean, new_var


def fold_bn_into_conv(weight: Tensor, bias: Optional[Tensor],
                      bn: nn.BatchNorm2d) -> Tuple[Tensor, Tensor]:
    """An eval-mode BatchNorm folded into the preceding conv, the
    counterpart of ``vit_grid_model_tpu/ops/nn.py::fold_bn_into_conv``:
    ``BN(conv(x)) == conv'(x)`` with ``w' = w * s`` and
    ``b' = (b - mean) * s + bias``, ``s = scale * rsqrt(var + eps)``.  OIHW
    weights keep the output channel first, depthwise convs included."""
    s = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    b = bias if bias is not None else torch.zeros_like(bn.running_mean)
    return (weight * s.view(-1, 1, 1, 1),
            (b - bn.running_mean) * s + bn.bias)


def chan_layer_norm(x: Tensor, g: Tensor, b: Tensor, *,
                    eps: float = 1e-5) -> Tensor:
    """LayerNorm over the channel axis of NCHW with biased variance and
    ``rsqrt(max(var, eps))``; g and b are (1, C, 1, 1)."""
    mean = x.mean(dim=1, keepdim=True)
    var = (x - mean).square().mean(dim=1, keepdim=True)
    return (x - mean) * torch.rsqrt(var.clamp(min=eps)) * g + b


def layer_norm(x: Tensor, weight: Optional[Tensor] = None,
               bias: Optional[Tensor] = None, *, eps: float = 1e-5) -> Tensor:
    """LayerNorm over the last axis: biased variance, ``rsqrt(var + eps)``,
    affine only when ``weight`` is given."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight + bias
    return y


def qk_rms_norm(x: Tensor, gamma: Tensor, *, eps: float = 1e-12) -> Tensor:
    """``x / max(||x||, eps) * sqrt(d) * gamma``; x (..., heads, n, d),
    gamma (heads, 1, d)."""
    d = x.shape[-1]
    norm = x.square().sum(dim=-1, keepdim=True).sqrt()
    return x / norm.clamp(min=eps) * (d ** 0.5) * gamma


# ---------------------------------------------------------------------------
# activations / pooling
# ---------------------------------------------------------------------------


def gelu(x: Tensor) -> Tensor:
    return F.gelu(x, approximate="none")


def silu(x: Tensor) -> Tensor:
    return F.silu(x)


def max_pool_2x(x: Tensor) -> Tensor:
    return F.max_pool2d(x, kernel_size=2, stride=2)


# ---------------------------------------------------------------------------
# parameter holders whose state_dict keys follow core/torch_export.py
# ---------------------------------------------------------------------------


class ChanLayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1))
        self.b = nn.Parameter(torch.zeros(1, dim, 1, 1))

    def forward(self, x: Tensor) -> Tensor:
        return chan_layer_norm(x, self.g, self.b)


class QKRMSNorm(nn.Module):
    def __init__(self, heads: int, dim_head: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(heads, 1, dim_head))

    def forward(self, x: Tensor) -> Tensor:
        return qk_rms_norm(x, self.gamma)


class SqueezeExcite(nn.Module):
    """mean-pool -> Linear -> ReLU -> Linear -> sigmoid gate; both linears
    bias-free.  ``gate`` keeps the reference's Sequential indices (the
    linears at 1 and 3) so the state_dict keys match."""

    def __init__(self, dim: int, shrinkage_rate: float = 0.25):
        super().__init__()
        hidden = int(dim * shrinkage_rate)
        self.gate = nn.Sequential(
            nn.Identity(), nn.Linear(dim, hidden, bias=False), nn.ReLU(),
            nn.Linear(hidden, dim, bias=False), nn.Sigmoid())

    def forward(self, x: Tensor) -> Tensor:
        return squeeze_excite(x, self.gate[1].weight, self.gate[3].weight)


def squeeze_excite(x: Tensor, w1: Tensor, w2: Tensor) -> Tensor:
    gate = x.mean(dim=(2, 3))
    gate = torch.relu(linear(gate, w1))
    gate = torch.sigmoid(linear(gate, w2))
    return x * gate[:, :, None, None]


class FiLM(nn.Sequential):
    """Linear -> SiLU -> Linear -> (gamma, beta)."""

    def __init__(self, cond_dim: int, dim: int):
        super().__init__(nn.Linear(cond_dim, dim * 2), nn.SiLU(),
                         nn.Linear(dim * 2, dim * 2))

    def forward(self, cond: Tensor) -> Tuple[Tensor, Tensor]:
        return film(cond, self[0], self[2])


def film(cond: Tensor, fc1: nn.Linear, fc2: nn.Linear) -> Tuple[Tensor, Tensor]:
    h = linear(silu(linear(cond, fc1.weight, fc1.bias)), fc2.weight, fc2.bias)
    gamma, beta = h.chunk(2, dim=-1)
    return gamma, beta
