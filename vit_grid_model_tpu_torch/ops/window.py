"""Window / grid partitioning for MaxViT block and grid attention.

Counterpart of ``vit_grid_model_tpu/ops/window.py``, over channels-last
(B, H, W, C) tensors so the window tokens come out as (Bw, n, C).

Block partition: 'b (x w1) (y w2) d -> (b x y) (w1 w2) d', local windows.
Grid partition:  'b (w1 x) (w2 y) d -> (b x y) (w1 w2) d', strided windows
(the outer factor is the window coordinate): token (i, j) of window (x, y)
sits at pixel (i*nx + x, j*ny + y).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor


def block_partition(x: Tensor, w: int) -> Tuple[Tensor, Tuple[int, int, int]]:
    """(B, H, W, C) -> ((B*nx*ny), w*w, C) local windows."""
    b, h, wd, c = x.shape
    nx, ny = h // w, wd // w
    x = x.reshape(b, nx, w, ny, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * nx * ny, w * w, c), (b, nx, ny)


def block_reverse(x: Tensor, w: int, dims: Tuple[int, int, int]) -> Tensor:
    b, nx, ny = dims
    c = x.shape[-1]
    x = x.reshape(b, nx, ny, w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, nx * w, ny * w, c)


def grid_partition(x: Tensor, w: int) -> Tuple[Tensor, Tuple[int, int, int]]:
    """(B, H, W, C) -> ((B*nx*ny), w*w, C) strided (dilated) windows."""
    b, h, wd, c = x.shape
    nx, ny = h // w, wd // w
    x = x.reshape(b, w, nx, w, ny, c).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b * nx * ny, w * w, c), (b, nx, ny)


def grid_reverse(x: Tensor, w: int, dims: Tuple[int, int, int]) -> Tensor:
    b, nx, ny = dims
    c = x.shape[-1]
    x = x.reshape(b, nx, ny, w, w, c).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, w * nx, w * ny, c)


def relative_position_indices(window_size: int, num_registers: int,
                              device=None) -> Tensor:
    """(n, n) int64 indices into the (2w-1)^2 + 1 row bias table for one
    (registers ++ window) token block; register rows and columns read the
    sentinel row (2w-1)^2."""
    w = window_size
    pos = torch.arange(w, device=device)
    gy, gx = torch.meshgrid(pos, pos, indexing="ij")
    grid = torch.stack([gy.reshape(-1), gx.reshape(-1)], dim=-1)   # (w*w, 2)
    rel = grid[:, None, :] - grid[None, :, :] + (w - 1)
    idx = rel[..., 0] * (2 * w - 1) + rel[..., 1]
    n = w * w + num_registers
    full = torch.full((n, n), (2 * w - 1) ** 2, dtype=torch.int64,
                      device=device)
    full[num_registers:, num_registers:] = idx
    return full
