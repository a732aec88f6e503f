"""The counter-hash attention-dropout keep mask, written out plainly.

A keep value is a pure function of (seed, window, head, row, col):

    idx  = ((win * heads + h) * n_pad + row) * n_pad + col      (mod 2**32)
    x    = idx ^ (seed * 0x9E3779B9)
    x    = (x ^ x >> 16) * 0x7FEB352D
    x    = (x ^ x >> 15) * 0x846CA68B
    x   ^= x >> 16
    keep = ((x >> 8) >= ceil(f32(rate) * 2**24)) / f32(1 - rate)

with ``n_pad`` the token count rounded up to 8 and every word taken modulo
2**32.  The words live in int64 tensors masked to 32 bits, and each
product is split into the constant's 16-bit halves so that nothing leaves
int64's range.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import Tensor

_M32 = 0xFFFFFFFF


def _mul32(x: Tensor, c: int) -> Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def keep_mask(seed: int, bw: int, heads: int, n: int, rate: float,
              device=None) -> Tensor:
    """(bw, heads, n, n) f32 keep values of windows 0..bw-1, each 0 or
    1 / (1 - rate) in f32."""
    threshold = math.ceil(float(np.float32(rate)) * 2.0 ** 24)
    scale = float(np.float32(1.0) / np.float32(1.0 - rate))
    n_pad = (n + 7) // 8 * 8
    win, h, row, col = (torch.arange(k, dtype=torch.int64, device=device)
                        for k in (bw, heads, n, n))
    idx = (((win[:, None, None, None] * heads + h[:, None, None]) * n_pad
            + row[:, None]) * n_pad + col) & _M32
    x = idx ^ ((seed * 0x9E3779B9) & _M32)
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    return ((x >> 8) >= threshold).to(torch.float32) * scale
