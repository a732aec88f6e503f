"""The card's published peaks and the least time of a piece of work.

Frozen copies: ``PEAK_FLOPS``, ``PEAK_BYTES`` and ``bound_ms`` of the
port's ``repros/common.py``; ``attention_bound_ms`` (the forward, here with
the peak of the dtype it runs in) and ``wgrad_bound_ms`` of
``chip_smoke.py``.
``attn_bwd_bound_ms`` counts the attention backward's own products: no
recompute of the forward, the two weight gradients included.
"""

from __future__ import annotations

from typing import Tuple

import torch

# the H100 SXM data sheet: dense tensor-core bf16 and int8, CUDA-core f32
# (TF32 off), HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.int8: 1979e12,
              torch.float32: 67e12}
PEAK_BYTES = 3.35e12


def bound_ms(ops: float, moved: float,
             dtype: torch.dtype) -> Tuple[float, str]:
    """(least ms, what bounds it) of work that does ``ops`` operations in
    ``dtype`` and must move ``moved`` bytes."""
    t_ops, t_bytes = ops / PEAK_FLOPS[dtype], moved / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "bytes" if t_bytes > t_ops else "operations")


def attention_fwd_flops(n: int, dim: int, heads: int, dh: int) -> int:
    """One window's forward products: qkv, scores, P.v, out-projection."""
    return (2 * n * dim * 3 * heads * dh + 4 * heads * n * n * dh
            + 2 * n * heads * dh * dim)


def attention_bound_ms(bw: int, n: int, dim: int, heads: int, dh: int,
                       item: int, dtype: torch.dtype = torch.bfloat16
                       ) -> Tuple[float, str]:
    """The window-attention forward at this shape: its products at the
    ``dtype`` peak against x read and y written once."""
    return bound_ms(bw * attention_fwd_flops(n, dim, heads, dh),
                    bw * n * dim * item * 2, dtype)


def wgrad_bound_ms(rows: int, dim: int, heads: int,
                   dh: int) -> Tuple[float, str]:
    """dWqkv = xf^T [dQ|dK|dV] and dWout = O^T dY over the rows at the bf16
    peak, against the bf16 operands read once and the f32 gradients
    written once."""
    ops = 2 * rows * dim * 3 * heads * dh + 2 * rows * heads * dh * dim
    moved = rows * (2 * dim + 4 * heads * dh) * 2 + 4 * heads * dim * dh * 4
    return bound_ms(ops, moved, torch.bfloat16)


def attention_bwd_flops(n: int, dim: int, heads: int, dh: int) -> int:
    """One window's backward products, without the forward's: dO = dY
    Wout^T; dV, dP, dQ, dK (four n x n x dh products a head); dXf = dQKV
    Wqkv^T; and the weight gradients dWqkv = Xf^T dQKV, dWout = O^T dY."""
    inner = heads * dh
    return (2 * n * dim * inner + 8 * heads * n * n * dh
            + 2 * n * 3 * inner * dim + 2 * n * dim * 3 * inner
            + 2 * n * inner * dim)


def attn_bwd_bound_ms(bw: int, n: int, dim: int, heads: int, dh: int,
                      item: int) -> Tuple[float, str]:
    """The attention backward at the bf16 peak, against its inputs (x,
    dy, the weights and tables) read once and its outputs (dx and every
    gradient, f32) written once."""
    weights = dim * 3 * heads * dh + heads * dh * dim
    small = 2 * heads * dh + heads * n * n
    moved = (bw * n * dim * item * 3 + weights * (item + 4)
             + small * 8)
    return bound_ms(bw * attention_bwd_flops(n, dim, heads, dh), moved,
                    torch.bfloat16)

