"""MaxViT backbone, eval mode: per layer [MBConv -> block attention -> grid
attention] with register tokens and FiLM lead-time conditioning.

Counterpart of ``vit_grid_model_tpu/models/maxvit.py::maxvit_apply``.  All
windows of a layer go through one window-attention call
(``ops/cuda/attention.py``: the CUDA kernel on the GPU, the plain version
on the CPU).  Quirks kept:

* stage dims double per stage but the first stage pair is (dim, dim);
* MBConv ``downsample`` only disables its residual, so the spatial size is
  constant through the backbone;
* block-attention registers are per window; before grid attention they are
  mean-reduced across a sample's windows and repeated sample-major;
* the attention residual (+x) includes the register tokens.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import Tensor, nn

from vit_grid_model_tpu_torch.ops import window as W
from vit_grid_model_tpu_torch.ops.attention import Attention
from vit_grid_model_tpu_torch.ops.cuda.attention import window_attention
from vit_grid_model_tpu_torch.ops.mbconv import mbconv


def layer_dims(dim: int, depth: Tuple[int, ...]) -> List[Tuple[int, int, bool]]:
    """(dim_in, dim_out, is_first) per layer, in the reference's order."""
    dims = tuple((2 ** i) * dim for i in range(len(depth)))
    pairs = (tuple(zip(dims[:-1], dims[1:])) if len(depth) > 1
             else ((dim, dim),))
    out = []
    for (stage_in, stage_dim), stage_depth in zip(pairs, depth):
        for i in range(stage_depth):
            out.append((stage_in if i == 0 else stage_dim, stage_dim, i == 0))
    return out


class MaxViT(nn.Module):
    """State_dict keys: ``layers.{i}.{0,1,2}`` (MBConv, block attention,
    grid attention) and ``register_tokens.{i}``."""

    def __init__(self, dim: int, *, depth: Tuple[int, ...], cond_dim: int,
                 heads: int, dim_head: int, window_size: int,
                 mbconv_expansion_rate: int, mbconv_shrinkage_rate: float,
                 num_register_tokens: int):
        super().__init__()
        self.window_size = window_size
        self.num_register_tokens = num_register_tokens
        attn = dict(cond_dim=cond_dim, heads=heads, dim_head=dim_head,
                    window_size=window_size)
        self.layers = nn.ModuleList()
        self.register_tokens = nn.ParameterList()
        for dim_in, dim_out, is_first in layer_dims(dim, depth):
            self.layers.append(nn.ModuleList([
                mbconv(dim_in, dim_out, downsample=is_first,
                       expansion_rate=mbconv_expansion_rate,
                       shrinkage_rate=mbconv_shrinkage_rate),
                Attention(dim_out, **attn),
                Attention(dim_out, **attn),
            ]))
            self.register_tokens.append(
                nn.Parameter(torch.randn(num_register_tokens, dim_out)))
        self.register_buffer(
            "bias_indices",
            W.relative_position_indices(window_size, num_register_tokens),
            persistent=False)

    def forward(self, x: Tensor, cond: Tensor) -> Tensor:
        """x: (B, C, H, W) with H, W divisible by the window size;
        cond: (B, cond_dim).  Returns (B, C', H, W)."""
        w, nr = self.window_size, self.num_register_tokens
        for (conv, block_attn, grid_attn), registers in zip(
                self.layers, self.register_tokens):
            x = conv(x)
            b, d = x.shape[0], x.shape[1]
            x = x.permute(0, 2, 3, 1)                       # (B, H, W, C)

            # block (local-window) attention
            xw, dims = W.block_partition(x, w)
            nwin = dims[1] * dims[2]
            r = registers.expand(xw.shape[0], nr, d)
            xw, r = self._attend(block_attn, xw, r, cond, nwin)
            x = W.block_reverse(xw, w, dims)

            # grid (strided-window) attention; registers averaged over the
            # sample's windows, then repeated sample-major
            r = r.reshape(b, nwin, nr, d).mean(dim=1)
            xw, dims = W.grid_partition(x, w)
            nwin = dims[1] * dims[2]
            r = r.repeat_interleave(nwin, dim=0)
            xw, r = self._attend(grid_attn, xw, r, cond, nwin)
            x = W.grid_reverse(xw, w, dims).permute(0, 3, 1, 2)
        return x

    def _attend(self, p: Attention, xw: Tensor, registers: Tensor,
                cond: Tensor, nwin: int):
        tokens = torch.cat([registers, xw], dim=1)          # (Bw, nr + n, d)
        out = window_attention(p, tokens, cond, self.bias_indices,
                               windows_per_sample=nwin)
        tokens = out + tokens                               # incl. registers
        nr = self.num_register_tokens
        return tokens[:, nr:], tokens[:, :nr]
