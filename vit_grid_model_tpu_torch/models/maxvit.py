"""MaxViT backbone: per layer [MBConv -> block attention -> grid attention]
with register tokens and FiLM lead-time conditioning.

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

Training, the counterpart of ``maxvit_apply(training=True)``: MBConv
batch-norms use batch statistics and append their updated running
statistics to ``bn_stats``; each attention call draws dropout at the
layer's rate from its own seed (two seeds per layer: block, then grid).
``fold_bn_eval`` folds the MBConv batch-norms into their convs at
inference only, as ``maxvit_apply`` does with ``spec.fold_bn_eval``.
Each layer opens the spans ``maxvit.mbconv``, ``maxvit.block_attn`` and
``maxvit.grid_attn`` (``utils/profiling.py::annotate``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import Tensor, nn

from vit_grid_model_tpu_torch.ops import window as W
from vit_grid_model_tpu_torch.ops.attention import Attention
from vit_grid_model_tpu_torch.ops.cuda.attention import window_attention
from vit_grid_model_tpu_torch.ops.mbconv import mbconv
from vit_grid_model_tpu_torch.utils.profiling import annotate


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
                 num_register_tokens: int, dropout: float = 0.0,
                 fold_bn_eval: bool = False):
        super().__init__()
        self.window_size = window_size
        self.dropout = dropout
        self.fold_bn_eval = fold_bn_eval
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

    def forward(self, x: Tensor, cond: Tensor, *,
                seeds: Optional[Sequence[int]] = None,
                bn_stats: Optional[List] = None, group=None,
                stop_after: Optional[str] = None) -> Tensor:
        """x: (B, C, H, W) with H, W divisible by the window size;
        cond: (B, cond_dim).  Returns (B, C', H, W).

        ``stop_after`` ("mbconv" | "block"): return the partial pipeline
        after that sub-stage of the first layer, as ``maxvit_apply``'s
        profiling hook does.

        Training: ``seeds`` holds two dropout seeds per layer, and turns
        attention dropout on at ``self.dropout``; a ``bn_stats`` list turns
        on training-mode MBConv batch-norms, which append to it, with
        their statistics over the global batch of the process ``group``."""
        w, nr = self.window_size, self.num_register_tokens
        for li, ((conv, block_attn, grid_attn), registers) in enumerate(zip(
                self.layers, self.register_tokens)):
            block_seed = grid_seed = None
            if seeds is not None:
                block_seed, grid_seed = seeds[2 * li], seeds[2 * li + 1]
            with annotate("maxvit.mbconv"):
                x = conv(x, bn_stats, self.fold_bn_eval, group)
            if stop_after == "mbconv":
                return x
            b, d = x.shape[0], x.shape[1]

            # block (local-window) attention
            with annotate("maxvit.block_attn"):
                x = x.permute(0, 2, 3, 1)                   # (B, H, W, C)
                xw, dims = W.block_partition(x, w)
                nwin = dims[1] * dims[2]
                r = registers.expand(xw.shape[0], nr, d)
                xw, r = self._attend(block_attn, xw, r, cond, nwin,
                                     block_seed)
                x = W.block_reverse(xw, w, dims)
            if stop_after == "block":
                return x.permute(0, 3, 1, 2)

            # grid (strided-window) attention; registers averaged over the
            # sample's windows, then repeated sample-major
            with annotate("maxvit.grid_attn"):
                r = r.reshape(b, nwin, nr, d).mean(dim=1)
                xw, dims = W.grid_partition(x, w)
                nwin = dims[1] * dims[2]
                r = r.repeat_interleave(nwin, dim=0)
                xw, r = self._attend(grid_attn, xw, r, cond, nwin, grid_seed)
                x = W.grid_reverse(xw, w, dims).permute(0, 3, 1, 2)
        return x

    def _attend(self, p: Attention, xw: Tensor, registers: Tensor,
                cond: Tensor, nwin: int, seed: Optional[int]):
        tokens = torch.cat([registers, xw], dim=1)          # (Bw, nr + n, d)
        out = window_attention(
            p, tokens, cond, self.bias_indices, windows_per_sample=nwin,
            seed=seed, dropout_rate=self.dropout if seed is not None else 0.0)
        tokens = out + tokens                               # incl. registers
        nr = self.num_register_tokens
        return tokens[:, nr:], tokens[:, :nr]
