"""The fused inference MBConv on the GPU (R15): the wrapper of
``csrc/fused_mbconv.cu`` and its launch counter.

``fused_mbconv(x, ops)`` takes the arguments of the plain version
``ops/mbconv.py::fused_mbconv_reference``: NHWC ``x`` and the operands of
``mbconv_kernel_operands`` (f32, BatchNorms folded in).  For a tensor on the
CPU it runs that plain version; for a CUDA tensor it launches the kernel
(three stages: expand + depthwise on row tiles, the SE gate, the project)
or raises.  The model's MBConv does not call it: the model runs the stock
ops, as the JAX package does; ``repros/fused_mbconv.py`` times the two
against each other.
"""

from __future__ import annotations

import torch
from torch import Tensor

from vit_grid_model_tpu_torch.ops.cuda import library
from vit_grid_model_tpu_torch.ops.mbconv import (Operands,
                                                 fused_mbconv_reference)

#: (C, HID, SE) widths the kernel is instantiated for: the shipped model's
#: and one small width for the odd-shape checks
WIDTHS = ((128, 512, 128), (32, 128, 32))

# Calls of the wrapper that launched the kernel (each call launches its
# three stages) since the count was last set to 0.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _check_operands(x: Tensor, ops: Operands) -> None:
    if len(ops) != 10:
        raise ValueError(f"fused_mbconv: 10 operands, got {len(ops)}")
    c = x.shape[-1]
    hid, se = ops[0].shape[1], ops[4].shape[1]
    shapes = [(c, hid), (hid,), (3, 3, hid), (hid,), (hid, se), (se,),
              (se, hid), (hid,), (hid, c), (c,)]
    for i, (t, shape) in enumerate(zip(ops, shapes)):
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_mbconv: operand {i} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if (t.dtype != torch.float32 or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"fused_mbconv: operand {i} must be contiguous "
                             f"f32 on {x.device}")
    if (c, hid, se) not in WIDTHS:
        raise ValueError(f"fused_mbconv: widths (C, HID, SE) = "
                         f"{(c, hid, se)} not in {WIDTHS}")


def fused_mbconv(x: Tensor, ops: Operands, *,
                 samples_per_block: int = 1) -> Tensor:
    """The fused MBConv of (N, H, W, C) ``x``; ``samples_per_block``
    samples share a block of each tiled stage (1 and 4 are the TPU repro's
    two settings)."""
    if x.device.type == "cpu":
        return fused_mbconv_reference(x, ops)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mbconv: no kernel for {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_mbconv: dtype {x.dtype} not supported")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("fused_mbconv: x must be contiguous (N, H, W, C)")
    if samples_per_block < 1:
        raise ValueError("fused_mbconv: samples_per_block must be >= 1")
    _check_operands(x, ops)
    n, h, w, c = x.shape
    hid = ops[0].shape[1]
    is_bf16 = int(x.dtype == torch.bfloat16)
    lib = library.load()
    rows = lib.vgm_fused_mbconv_row_tile(w, c, is_bf16)
    if rows == 0:
        raise ValueError(f"fused_mbconv: rows of {w} pixels do not fit in "
                         "shared memory")
    tiles = -(-h // rows)
    out = torch.empty_like(x)
    h2 = torch.empty(n, h, w, hid, dtype=x.dtype, device=x.device)
    partial = torch.empty(n, tiles, hid, device=x.device)
    gate = torch.empty(n, hid, device=x.device)
    library.check(lib.vgm_fused_mbconv(
        x.data_ptr(), *(t.data_ptr() for t in ops), out.data_ptr(),
        h2.data_ptr(), partial.data_ptr(), gate.data_ptr(), n, h, w, c, hid,
        ops[4].shape[1], is_bf16, samples_per_block, library.stream(x)),
        "fused_mbconv")
    global launches
    launches += 1
    return out
