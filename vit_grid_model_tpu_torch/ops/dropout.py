"""Counter-hash attention-dropout keep mask: the plain PyTorch version.

Counterpart of ``vit_grid_model_tpu/ops/pallas/attention.py::_hash_keep``
with its index builders ``_keep_mask`` and ``_keep_mask_pair``.  The CUDA
kernels evaluate the same function inline (``csrc/dropout_hash.cuh``), so
the masks agree bit for bit: a keep value is a pure function of (seed,
window, head, row, col).

    idx  = ((win * heads + h) * n_pad + row) * n_pad + col      (mod 2**32)
    x    = idx ^ (seed * 0x9E3779B9)
    x    = (x ^ x >> 16) * 0x7FEB352D
    x    = (x ^ x >> 15) * 0x846CA68B
    x   ^= x >> 16
    keep = ((x >> 8) * 2**-24 >= rate) / (1 - rate)

``win`` is the global window index and ``n_pad = round_up(n, 8)`` (56 for
the 53-token windows).  Everything is modulo 2**32.  torch has little
uint32 arithmetic, so the words are int64 tensors masked with
``& 0xFFFFFFFF``, and each product is split into 16-bit halves of the
constant so that no intermediate leaves int64's range.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import Tensor

_M32 = 0xFFFFFFFF


def keep_constants(rate: float) -> Tuple[int, float]:
    """(threshold, scale) of a dropout rate: a score is kept iff
    ``x >> 8 >= threshold``, and then scaled by ``scale``.

    ``threshold = ceil(f32(rate) * 2**24)`` is the exact integer form of
    the JAX comparison ``u >= rate`` in f32 (u is a multiple of 2**-24),
    and ``scale = f32(1) / f32(1 - rate)`` is its f32 division."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} is not in [0, 1)")
    threshold = int(np.ceil(np.float64(np.float32(rate)) * 2.0 ** 24))
    scale = float(np.float32(1.0) / np.float32(1.0 - rate))
    return threshold, scale


def _mul32(x: Tensor, c: int) -> Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a 32-bit constant."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_keep(idx: Tensor, seed: int, rate: float) -> Tensor:
    """Pre-scaled f32 keep values of int64 element indices."""
    threshold, scale = keep_constants(rate)
    x = (idx & _M32) ^ ((seed * 0x9E3779B9) & _M32)
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    # scale is an f32 value, so {0, 1} * scale is exact
    return ((x >> 8) >= threshold).to(torch.float32) * scale


def keep_mask(seed: int, bw: int, heads: int, n: int, rate: float, *,
              device: Optional[torch.device] = None) -> Tensor:
    """The pre-scaled (bw, heads, n, n) f32 keep mask of windows 0..bw-1,
    values in {0, 1 / (1 - rate)}."""
    n_pad = (n + 7) // 8 * 8
    win, h, row, col = (torch.arange(k, dtype=torch.int64, device=device)
                        for k in (bw, heads, n, n))
    idx = (((win[:, None, None, None] * heads + h[:, None, None]) * n_pad
            + row[:, None]) * n_pad + col)
    return hash_keep(idx, seed, rate)
