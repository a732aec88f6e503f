"""The fused inference MBConv on the GPU (R15): the wrapper of
``csrc/fused_mbconv.cu`` and its launch counters.

``fused_mbconv(x, ops)`` takes the arguments of the plain version
``ops/mbconv.py::fused_mbconv_reference``: NHWC ``x`` and the operands of
``mbconv_kernel_operands`` (f32, BatchNorms folded in).  For a tensor on the
CPU it runs that plain version; for a CUDA tensor it launches the kernel
or raises.  The kernel has two designs, and ``route`` names the one a
launch takes, as the kernel's own ``vgm_fused_mbconv_route`` says:

* "bands" (bf16): a prep that packs the weights into bf16 core matrices
  once a call (``packed_reference`` is its plain version), expand +
  depthwise on bands of up to 7 rows (``rows``) with the products on
  wgmma, the SE gate, and a persistent wgmma project;
* "first" (f32): row tiles for expand + depthwise, the SE gate, the
  project on 64-pixel tiles, the products on CUDA-core FMAs.

The model's MBConv does not call it: the model runs the stock ops, as the
JAX package does; ``repros/fused_mbconv.py`` times the two against each
other.
"""

from __future__ import annotations

from collections import Counter

import torch
from torch import Tensor

from vit_grid_model_tpu_torch.ops.cuda import library
from vit_grid_model_tpu_torch.ops.mbconv import (Operands,
                                                 fused_mbconv_reference)

#: (C, HID, SE) widths the kernel is instantiated for: the shipped model's
#: and one small width for the odd-shape checks
WIDTHS = ((128, 512, 128), (32, 128, 32))
#: the designs, indexed by ``vgm_fused_mbconv_route``'s answer
ROUTES = ("first", "bands")

# Calls of the wrapper that launched the kernel (each call launches its
# stages) since the count was last set to 0, in all and by design.
launches = 0
launches_by_route: Counter = Counter()


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_route.clear()


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


def route(n: int, h: int, w: int, c: int, hid: int, se: int,
          dtype: torch.dtype) -> str:
    """The design a launch on (n, h, w, c) ``x`` with hidden ``hid`` and SE
    ``se`` takes: "bands" in bf16, "first" in f32.  Raises at widths other
    than ``WIDTHS`` and on rows too wide for the design's plan (more than
    149 pixels at C 128 in bf16)."""
    r = library.load().vgm_fused_mbconv_route(
        n, h, w, c, hid, se, int(dtype == torch.bfloat16))
    if r < 0:
        raise ValueError(f"fused_mbconv: no design takes (n, h, w, c, hid, "
                         f"se) = {(n, h, w, c, hid, se)}")
    return ROUTES[r]


def rows(w: int, c: int, dtype: torch.dtype) -> int:
    """Output rows that one row of the kernel's ``partial`` covers on the
    design a launch on rows of ``w`` pixels with ``c`` channels takes: a
    band's (7, fewer on rows too wide for seven) in bf16, a row tile's in
    f32; 0 where none fits.  The kernel's ``vgm_fused_mbconv_row_tile``
    says."""
    return library.load().vgm_fused_mbconv_row_tile(
        w, c, int(dtype == torch.bfloat16))


def core_matrices(wt: Tensor) -> Tensor:
    """A K-major (rows, K) operand as the flat no-swizzle core matrices of
    ``wgmma_common.cuh::core_offset``: 8 x 8 blocks, block (r / 8, k / 8)
    at element 64 ((r / 8) (K / 8) + k / 8), row-major inside."""
    rows, k = wt.shape
    return (wt.reshape(rows // 8, 8, k // 8, 8).permute(0, 2, 1, 3)
            .reshape(-1))


def packed_reference(ops: Operands) -> Tensor:
    """The plain version of the bands design's prep: we^T (HID x C) and
    wp^T (C x HID) rounded to bf16 as core matrices, then the taps (3, 3,
    HID) rounded to bf16, one flat bf16 tensor on the operands' device."""
    we, wd, wp = ops[0], ops[2], ops[8]
    return torch.cat([core_matrices(we.t()), core_matrices(wp.t()),
                      wd.reshape(-1)]).to(torch.bfloat16)


def pack(ops: Operands) -> Tensor:
    """The bands design's prep kernel alone on CUDA operands (the launch
    that ``fused_mbconv`` makes first on that design); counted nowhere."""
    we, wd, wp = ops[0], ops[2], ops[8]
    c, hid = we.shape
    lib = library.load()
    out = torch.empty(lib.vgm_fused_mbconv_packed_elems(c, hid),
                      dtype=torch.bfloat16, device=we.device)
    library.check(lib.vgm_fused_mbconv_pack(
        we.data_ptr(), wd.data_ptr(), wp.data_ptr(), out.data_ptr(), c, hid,
        library.stream(we)), "fused_mbconv prep")
    return out


def fused_mbconv(x: Tensor, ops: Operands, *,
                 samples_per_block: int = 1) -> Tensor:
    """The fused MBConv of (N, H, W, C) ``x``; ``samples_per_block``
    samples share a block of the expand/depthwise stage (1 and 4 are the
    TPU repro's two settings; on the bands design a block walks one band
    of each of them in turn, and the output does not depend on it)."""
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
    hid, se = ops[0].shape[1], ops[4].shape[1]
    is_bf16 = int(x.dtype == torch.bfloat16)
    lib = library.load()
    design = route(n, h, w, c, hid, se, x.dtype)
    packed = None
    if design == "bands":
        packed = torch.empty(lib.vgm_fused_mbconv_packed_elems(c, hid),
                             dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x)
    h2 = torch.empty(n, h, w, hid, dtype=x.dtype, device=x.device)
    partial = torch.empty(n, -(-h // rows(w, c, x.dtype)), hid,
                          device=x.device)
    gate = torch.empty(n, hid, device=x.device)
    library.check(lib.vgm_fused_mbconv(
        x.data_ptr(), *(t.data_ptr() for t in ops), out.data_ptr(),
        h2.data_ptr(), partial.data_ptr(), gate.data_ptr(),
        None if packed is None else packed.data_ptr(), n, h, w, c, hid, se,
        is_bf16, samples_per_block, library.stream(x)), "fused_mbconv")
    global launches
    launches += 1
    launches_by_route[design] += 1
    return out
