"""The least time of the station-to-grid LSTM's joint attention: one head
of width E over n = grid cells + stations tokens, B samples.

Its products are the in-projection (q, k, v), the scores q k^T, the
weighted sum P v and the out-projection; the bytes it must move are its
tokens read once and its result written once.  The bound is the larger of
the products at the configuration's peak and the bytes at the card's
bandwidth.
"""

from __future__ import annotations

from typing import Tuple

from gridbench.common.peaks import PEAK_BYTES


def joint_attention_flops(b: int, n: int, e: int) -> int:
    """2 x the multiply-adds of one joint attention's products."""
    return b * (2 * n * e * 3 * e + 2 * n * n * e + 2 * n * n * e
                + 2 * n * e * e)


def joint_attention_bytes(b: int, n: int, e: int, item: int) -> int:
    """Its tokens read and its result written, once each."""
    return 2 * b * n * e * item


def joint_bound_ms(b: int, n: int, e: int, item: int,
                   peak_flops: float) -> Tuple[float, str]:
    """(least ms, what bounds it) of one joint attention."""
    t_ops = joint_attention_flops(b, n, e) / peak_flops
    t_bytes = joint_attention_bytes(b, n, e, item) / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "bytes" if t_bytes > t_ops else "operations")
