"""The controls: the plain reference computed one step below the precision
that a configuration states.

* bfloat16 configurations: ``Fp8``, every operand of every product rounded
  to float8 e4m3 with one scale per tensor (its largest magnitude mapped
  to 448), and in the backward every incoming gradient of those operands
  to float8 e5m2 the same way (the usual fp8 training recipe);
* float32 with TF32 off: the reference with TF32 on (``tf32``), which a
  later change could turn on for speed.
"""

from __future__ import annotations

import contextlib

import torch
from torch import Tensor

from gridbench.reference.metnet3 import Precision


def _round(t: Tensor, dtype: torch.dtype, largest: float) -> Tensor:
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = largest / amax
    return ((t.float() * scale).to(dtype).float() / scale).to(t.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


class Fp8(Precision):
    def operand(self, t: Tensor) -> Tensor:
        return _Fp8.apply(t)


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 products in matmuls and convolutions while inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def control(dtype: str):
    """(Precision, TF32 on) of the control of a configuration's dtype."""
    if dtype == "bfloat16":
        return Fp8(), False
    if dtype == "float32":
        return Precision(), True
    raise ValueError(f"no control for compute dtype {dtype!r}")
