"""The masked single-head attention core of the legacy station and grid
models in one streaming pass on the GPU: the wrapper of
``csrc/joint_attention.cu`` and its counters.

``joint_attention(qkv, key_padding_mask)`` computes what
``ops/recurrent.py::attention_core`` computes: from the in-projection's
(B, n, 3E) output, softmax(q k^T / sqrt(E)) v over the keys the (B, n) bool
mask leaves valid (True excludes a key), a row with no valid key giving
zeros.  The kernel never forms the (B, n, n) score map: it streams the keys
through an online softmax in f32 on the CUDA cores.  It launches the
kernel or raises, naming what the kernel does not take.

``ops/recurrent.py::mha_self_attention`` takes the kernel where ``route``
says "streaming": a CUDA f32 input that autograd does not need, at a width
in ``WIDTHS``.  Every other call (the CPU, training, other dtypes or
widths) runs the eager core, and ``count_eager`` counts it.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Sequence

import torch
from torch import Tensor

from vit_grid_model_tpu_torch.ops.cuda import library

# the head widths the kernel is instantiated for: the station and grid
# models' hidden width
WIDTHS = (128,)
MAX_BATCH = 65535   # the launch grid's second dimension

# Since the counts were last set to 0: the kernel's launches, and the calls
# of ``mha_self_attention`` by the route each took.
launches = 0
launches_by_route: Counter = Counter()


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_route.clear()


def count_eager() -> None:
    """Count one call that ran the eager core."""
    launches_by_route["eager"] += 1


def refusal(x: Tensor, params: Sequence[Tensor] = (),
            key_padding_mask: Optional[Tensor] = None) -> Optional[str]:
    """Why the kernel does not take the attention of ``x`` (B, n, E) with
    these parameters and mask, or None where it does."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, *params)):
        return "an operand requires grad (the kernel has no backward)"
    if x.dtype != torch.float32:
        return f"dtype {x.dtype}"
    if x.dim() != 3:
        return f"x has {x.dim()} dimensions, not (B, n, E)"
    b, n, e = x.shape
    if e not in WIDTHS:
        return f"width {e} (the kernel's: {WIDTHS})"
    if not 1 <= b <= MAX_BATCH or n < 1:
        return f"batch {b}, {n} tokens"
    if key_padding_mask is not None and (
            key_padding_mask.dtype != torch.bool
            or tuple(key_padding_mask.shape) != (b, n)
            or key_padding_mask.device != x.device):
        return "the key mask is not (B, n) bool on x's device"
    if x.device.type != "cuda":
        return f"no kernel for {x.device}"
    return None


def route(x: Tensor, params: Sequence[Tensor] = (),
          key_padding_mask: Optional[Tensor] = None) -> str:
    """"streaming" where the kernel takes this call, else "eager"."""
    return "eager" if refusal(x, params, key_padding_mask) else "streaming"


def joint_attention(qkv: Tensor,
                    key_padding_mask: Optional[Tensor] = None) -> Tensor:
    """The attention core of (B, n, 3E) ``qkv``: (B, n, E)."""
    e3 = qkv.shape[-1]
    why = (refusal(qkv[..., :e3 // 3], (qkv,), key_padding_mask)
           if e3 % 3 == 0 else f"last dimension {e3} is not 3E")
    if why is not None:
        raise ValueError(f"joint_attention: {why}")
    return launch(qkv, key_padding_mask)


def launch(qkv: Tensor, key_padding_mask: Optional[Tensor] = None) -> Tensor:
    """Launch the kernel on a (B, n, 3E) in-projection output that
    ``route`` took (its (B, n, E) input, that is); no check of its own."""
    global launches
    b, n, e3 = qkv.shape
    qkv = qkv.contiguous()
    mask = (None if key_padding_mask is None
            else key_padding_mask.contiguous())
    out = qkv.new_empty((b, n, e3 // 3))
    library.check(library.load().vgm_joint_attention(
        qkv.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), b, n, e3 // 3, library.stream(qkv)),
        "joint_attention")
    launches += 1
    launches_by_route["streaming"] += 1
    return out
