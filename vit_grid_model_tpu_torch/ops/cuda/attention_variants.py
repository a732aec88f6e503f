"""Two TPU attention repros on the GPU: the wrappers of their hand-written
CUDA kernels under ``csrc/`` and their launch counters.

* ``perhead_attention`` (``perhead_attention.cu``): R1, and R14 at 16
  windows a CTA;
* ``maxvit_layer_attention`` (``maxvit_layer_attention.cu``): R7, one
  MaxViT layer's block and grid attention in one cluster launch.

Each takes the arguments of its plain version in ``ops/attention_variants.py``
(plus ``windows_per_cta`` for R1).  For a tensor on the CPU it runs that
plain version; for a CUDA tensor it launches the kernel or raises.  The
kernels live in the library that ``ops/cuda/library.py`` builds.
"""

from __future__ import annotations

from collections import Counter

import torch
from torch import Tensor

from vit_grid_model_tpu_torch.ops import attention_variants as plain
from vit_grid_model_tpu_torch.ops.cuda import library
from vit_grid_model_tpu_torch.ops.cuda.attention import MAX_SMEM

# Calls of each wrapper that launched its kernel since the counts were last
# set to 0; the per-head kernel's by windows a CTA (8 is R1, 16 is R14).
perhead_launches: Counter = Counter()
layer_launches = 0     # R7


def reset_launches() -> None:
    global layer_launches
    perhead_launches.clear()
    layer_launches = 0


def _check_cuda(name: str, x: Tensor, dim: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtype {x.dtype} not supported")
    if x.dim() != dim or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous with {dim} axes, "
                         f"got {tuple(x.shape)}")


def _check_operand(name: str, what: str, t: Tensor, shape, dtype,
                   device) -> None:
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"{name}: {what} must be contiguous {dtype} "
                         f"{tuple(shape)} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def perhead_attention(x: Tensor, wqkv: Tensor, bias: Tensor,
                      windows_per_cta: int) -> Tensor:
    """R1's per-head attention of (Bw, n, dim) ``x`` with ``wqkv`` (dim,
    3 * heads * dh) in R1's q | k | v layout and ``bias`` (heads, n, n) f32;
    each CTA runs ``windows_per_cta`` windows (8 is R1, 16 is R14)."""
    heads = bias.shape[0]
    dh = wqkv.shape[1] // (3 * heads)
    if x.device.type == "cpu":
        return plain.perhead_qkv_attention(x, wqkv, bias, heads, dh)
    name = "perhead_attention"
    _check_cuda(name, x, 3)
    bw, n, dim = x.shape
    _check_operand(name, "wqkv", wqkv, (dim, 3 * heads * dh), x.dtype,
                   x.device)
    _check_operand(name, "bias", bias, (heads, n, n), torch.float32,
                   x.device)
    if not (n <= 64 and dim % 16 == 0 and dh % 16 == 0 and dh <= 64
            and windows_per_cta >= 1):
        raise ValueError(f"{name}: n={n} (<= 64), dim={dim} and dim_head="
                         f"{dh} (multiples of 16, dim_head <= 64), "
                         f"windows_per_cta={windows_per_cta} (>= 1) out of "
                         "the kernel's range")
    is_bf16 = int(x.dtype == torch.bfloat16)
    lib = library.load()
    if lib.vgm_perhead_attention_smem_bytes(dim, dh, is_bf16) > MAX_SMEM:
        raise ValueError(f"{name}: dim={dim}, dim_head={dh} do not fit in "
                         "shared memory")
    # per-head weight slices (heads, dim, 3*dh): head h's q | k | v columns
    w = (wqkv.reshape(dim, 3, heads, dh).permute(2, 0, 1, 3)
         .reshape(heads, dim, 3 * dh).contiguous())
    out = torch.empty(bw, n, heads * dh, dtype=x.dtype, device=x.device)
    library.check(lib.vgm_perhead_attention(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), bw, n,
        dim, heads, dh, windows_per_cta, is_bf16, library.stream(x)), name)
    perhead_launches[windows_per_cta] += 1
    return out


def maxvit_layer_attention(x_map: Tensor, regs: Tensor, ops_block,
                           ops_grid, window_size: int) -> Tensor:
    """R7: one MaxViT layer's block attention, register mean and grid
    attention of the (S, H, W, dim) maps, with the residuals, in one
    launch; the arguments of ``ops/attention_variants.py::
    maxvit_layer_attention``."""
    if x_map.device.type == "cpu":
        return plain.maxvit_layer_attention(x_map, regs, ops_block, ops_grid,
                                            window_size)
    name = "maxvit_layer_attention"
    _check_cuda(name, x_map, 4)
    s, h, w, dim = x_map.shape
    nr = regs.shape[0]
    n = nr + window_size * window_size
    heads, _, three_dh = ops_block.wqkv.shape
    dh = three_dh // 3
    dev, dt, f32 = x_map.device, x_map.dtype, torch.float32
    _check_operand(name, "regs", regs, (nr, dim), dt, dev)
    for label, ops in (("block", ops_block), ("grid", ops_grid)):
        shapes = ((s, dim), (s, dim), (heads, dim, 3 * dh), (heads, dh, dim),
                  (heads, dh), (heads, dh), (heads, n, n))
        dtypes = (f32, f32, dt, dt, f32, f32, f32)
        for field, shape, dtype in zip(ops._fields[:7], shapes, dtypes):
            _check_operand(name, f"{label} {field}", getattr(ops, field),
                           shape, dtype, dev)
    is_bf16 = int(dt == torch.bfloat16)
    lib = library.load()
    if lib.vgm_maxvit_layer_attention_cluster(h, w, window_size, nr, dim, dh,
                                              is_bf16) == 0:
        raise ValueError(f"{name}: map {h}x{w}, window {window_size}, {nr} "
                         f"registers, dim={dim}, dim_head={dh} out of the "
                         "kernel's range (windows must tile the map, a "
                         "window hold <= 64 tokens, and a cluster of <= 16 "
                         "CTAs hold the map)")
    out = torch.empty_like(x_map)
    library.check(lib.vgm_maxvit_layer_attention(
        x_map.data_ptr(), regs.data_ptr(),
        *(t.data_ptr() for t in ops_block[:7]),
        *(t.data_ptr() for t in ops_grid[:7]), out.data_ptr(), s, h, w,
        window_size, nr, dim, heads, dh, is_bf16, library.stream(x_map)),
        name)
    global layer_launches
    layer_launches += 1
    return out
