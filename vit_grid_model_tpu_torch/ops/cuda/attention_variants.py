"""The TPU attention repros on the GPU: the wrappers of their hand-written
CUDA kernels under ``csrc/`` and their launch counters.

* ``perhead_attention`` (``perhead_attention.cu``): R1, and R14 at 16
  windows a CTA;
* ``perhead_weight_attention`` (the same kernel): R9, from its (3, heads,
  dim, dim_head) weight;
* ``headmajor_attention`` (``headmajor_attention.cu``): R4, a group of
  heads' q|k|v at once, then a warp per query row;
* ``stacked_softmax_attention`` (``stacked_softmax_attention.cu``): R10,
  one softmax over a group of heads' stacked scores;
* ``staged_attention_core`` (``staged_attention_core.cu``): R11's core on
  head-major operands, and ``staged_attention``, R11 whole, whose staging
  around the kernel is stock PyTorch (cuBLAS), as the repro leaves it to
  XLA;
* ``maxvit_layer_attention`` (``maxvit_layer_attention.cu``): R7, one
  MaxViT layer's block and grid attention in one cluster launch;
* ``crosshead_norm_attention`` (``crosshead_norm_attention.cu``): R3, R4's
  structure with a group's q/k norms from one product with a 0/1
  indicator;
* ``outproj_attention`` (``outproj_attention.cu``): R12, R13, R2 and R8,
  R1's function plus the out-projection, with the pass, out-projection,
  cast, windows-a-CTA and n choices at run time;
* ``headpack_attention`` (``headpack_attention.cu``): R5 and R6, the same
  function with a pack of K heads' q|k|v from one product and one
  out-projection a pack.

Each takes the arguments of its plain version in ``ops/attention_variants.py``
(plus the windows a CTA or heads a group, where the kernel has them).  For
a tensor on the CPU it runs that plain version; for a CUDA tensor it
launches the kernel or raises.  The kernels live in the library that
``ops/cuda/library.py`` builds.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch
from torch import Tensor

from vit_grid_model_tpu_torch.ops import attention_variants as plain
from vit_grid_model_tpu_torch.ops.cuda import library
from vit_grid_model_tpu_torch.ops.cuda.attention import MAX_SMEM

SM_SMEM = 233472       # shared memory of one SM (228 KB)
RESERVED_SMEM = 1024   # what the runtime keeps of it for each resident CTA

# Calls of each wrapper that launched its kernel since the counts were last
# set to 0; the per-head kernel's by windows a CTA (8 is R1, 16 is R14).
perhead_launches: Counter = Counter()
perhead_weight_launches = 0   # R9, on the per-head kernel
headmajor_launches = 0        # R4
stacked_launches = 0          # R10
staged_core_launches = 0      # R11's core
layer_launches = 0            # R7
crosshead_launches = 0        # R3
# R12, R13, R2 and R8's kernel, by (two_pass, perhead_wout, bf16_score,
# bf16_agg, windows_per_cta)
outproj_launches: Counter = Counter()
# R5 and R6's kernel, by (k_pack, two_pass, windows_per_cta)
headpack_launches: Counter = Counter()

WINDOWS_PER_CTA = 8           # R4, R9 and R10, as R1


def reset_launches() -> None:
    global perhead_weight_launches, headmajor_launches, stacked_launches
    global staged_core_launches, layer_launches, crosshead_launches
    perhead_launches.clear()
    outproj_launches.clear()
    headpack_launches.clear()
    perhead_weight_launches = headmajor_launches = stacked_launches = 0
    staged_core_launches = layer_launches = crosshead_launches = 0


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


def _check_widths(name: str, n: int, dim: int, dh: int) -> None:
    if not (n <= 64 and dim % 16 == 0 and dh % 16 == 0 and dh <= 64):
        raise ValueError(f"{name}: n={n} (<= 64), dim={dim} and dim_head="
                         f"{dh} (multiples of 16, dim_head <= 64) out of the "
                         "kernel's range")


def _check_rows(name: str, x: Tensor, w_heads: Tensor, bias: Tensor):
    """Checks x (Bw, n, dim), the per-head weights (heads, dim, 3dh) and
    the bias of the per-head kernels; returns (Bw, n, dim, heads, dh)."""
    _check_cuda(name, x, 3)
    bw, n, dim = x.shape
    heads = bias.shape[0]
    dh = w_heads.shape[-1] // 3
    _check_operand(name, "per-head weights", w_heads, (heads, dim, 3 * dh),
                   x.dtype, x.device)
    _check_operand(name, "bias", bias, (heads, n, n), torch.float32,
                   x.device)
    _check_widths(name, n, dim, dh)
    return bw, n, dim, heads, dh


def _per_head(wqkv: Tensor, heads: int) -> Tensor:
    """R1's (dim, 3 * heads * dh) q | k | v weight as per-head slices
    (heads, dim, 3 * dh): head h's q | k | v columns."""
    if wqkv.dim() != 2 or wqkv.shape[1] % (3 * heads):
        raise ValueError(f"wqkv {tuple(wqkv.shape)} is not (dim, 3 * "
                         f"{heads} * dim_head)")
    dim = wqkv.shape[0]
    dh = wqkv.shape[1] // (3 * heads)
    return (wqkv.reshape(dim, 3, heads, dh).permute(2, 0, 1, 3)
            .reshape(heads, dim, 3 * dh).contiguous())


def _launch_perhead(name: str, x: Tensor, w_heads: Tensor, bias: Tensor,
                    windows_per_cta: int) -> Tensor:
    bw, n, dim, heads, dh = _check_rows(name, x, w_heads, bias)
    if windows_per_cta < 1:
        raise ValueError(f"{name}: windows_per_cta={windows_per_cta} (>= 1)")
    is_bf16 = int(x.dtype == torch.bfloat16)
    lib = library.load()
    if lib.vgm_perhead_attention_smem_bytes(dim, dh, is_bf16) > MAX_SMEM:
        raise ValueError(f"{name}: dim={dim}, dim_head={dh} do not fit in "
                         "shared memory")
    out = torch.empty(bw, n, heads * dh, dtype=x.dtype, device=x.device)
    library.check(lib.vgm_perhead_attention(
        x.data_ptr(), w_heads.data_ptr(), bias.data_ptr(), out.data_ptr(), bw,
        n, dim, heads, dh, windows_per_cta, is_bf16, library.stream(x)), name)
    return out


def perhead_attention(x: Tensor, wqkv: Tensor, bias: Tensor,
                      windows_per_cta: int) -> Tensor:
    """R1's per-head attention of (Bw, n, dim) ``x`` with ``wqkv`` (dim,
    3 * heads * dh) in R1's q | k | v layout and ``bias`` (heads, n, n) f32;
    each CTA runs ``windows_per_cta`` windows (8 is R1, 16 is R14)."""
    heads = bias.shape[0]
    if x.device.type == "cpu":
        return plain.perhead_qkv_attention(x, wqkv, bias, heads,
                                           wqkv.shape[1] // (3 * heads))
    out = _launch_perhead("perhead_attention", x, _per_head(wqkv, heads),
                          bias, windows_per_cta)
    perhead_launches[windows_per_cta] += 1
    return out


def perhead_weight_attention(x: Tensor, w4: Tensor, bias: Tensor) -> Tensor:
    """R9: R1's function from the weight R9 hands its kernel, ``w4`` (3,
    heads, dim, dh) = R1's wqkv split by (q|k|v, head).  It is rearranged
    once into the per-head kernel's (heads, dim, 3 * dh) slices, which the
    kernel runs at 8 windows a CTA: that kernel is R9's structure."""
    _, heads, dim, dh = w4.shape
    if x.device.type == "cpu":
        return plain.perhead_qkv_attention(
            x, w4.permute(2, 0, 1, 3).reshape(dim, 3 * heads * dh), bias,
            heads, dh)
    out = _launch_perhead(
        "perhead_weight_attention", x,
        w4.permute(1, 2, 0, 3).reshape(heads, dim, 3 * dh).contiguous(),
        bias, WINDOWS_PER_CTA)
    global perhead_weight_launches
    perhead_weight_launches += 1
    return out


def _pick_group(smem_bytes, dim: int, dh: int, heads: int, is_bf16: int,
                most: int, ctas_per_sm: int) -> int:
    """The largest power of two <= ``most`` and <= heads of which
    ``ctas_per_sm`` CTAs share an SM's shared memory; else the largest of
    which one CTA fits (0 when not even one head does)."""
    def largest(limit):
        group = 1
        while 2 * group <= min(most, heads):
            group *= 2
        while group and smem_bytes(dim, dh, group, is_bf16) > limit:
            group //= 2
        return group

    return (largest(SM_SMEM // ctas_per_sm - RESERVED_SMEM)
            or largest(MAX_SMEM))


def _launch_grouped(name: str, entry: str, x: Tensor, wqkv: Tensor,
                    bias: Tensor, heads_per_group: Optional[int], most: int,
                    ctas_per_sm: int) -> Tensor:
    """Launch R4's or R10's kernel (library entry ``entry``), ``heads_per_
    group`` heads a step (default: ``_pick_group``), 8 windows a CTA."""
    heads = bias.shape[0]
    w_heads = _per_head(wqkv, heads)
    bw, n, dim, heads, dh = _check_rows(name, x, w_heads, bias)
    is_bf16 = int(x.dtype == torch.bfloat16)
    lib = library.load()
    smem_bytes = getattr(lib, entry + "_smem_bytes")
    group = heads_per_group or _pick_group(smem_bytes, dim, dh, heads,
                                           is_bf16, most, ctas_per_sm)
    if not (1 <= group <= heads
            and smem_bytes(dim, dh, group, is_bf16) <= MAX_SMEM):
        raise ValueError(f"{name}: {group} heads of dim={dim}, dim_head={dh} "
                         f"a group do not fit in shared memory or {heads} "
                         "heads")
    out = torch.empty(bw, n, heads * dh, dtype=x.dtype, device=x.device)
    library.check(getattr(lib, entry)(
        x.data_ptr(), w_heads.data_ptr(), bias.data_ptr(), out.data_ptr(), bw,
        n, dim, heads, dh, group, WINDOWS_PER_CTA, is_bf16,
        library.stream(x)), name)
    return out


def headmajor_attention(x: Tensor, wqkv: Tensor, bias: Tensor,
                        heads_per_group: Optional[int] = None) -> Tensor:
    """R4: R1's function (its arguments) with a group of heads' q|k|v
    computed at once and stored head-major, then a warp per query row with
    no block barrier between the group's heads.  Unless given, the group is
    the largest (up to 2 heads) of which two CTAs share an SM, since the
    kernel is latency-bound: 1 head in bf16 at the repro's widths, 2 in
    f32, where no group lets two CTAs share an SM."""
    heads = bias.shape[0]
    if x.device.type == "cpu":
        return plain.perhead_qkv_attention(x, wqkv, bias, heads,
                                           wqkv.shape[1] // (3 * heads))
    out = _launch_grouped("headmajor_attention", "vgm_headmajor_attention",
                          x, wqkv, bias, heads_per_group, 2, 2)
    global headmajor_launches
    headmajor_launches += 1
    return out


def stacked_softmax_attention(x: Tensor, wqkv: Tensor,
                              bias: Tensor) -> Tensor:
    """R10: R1's function (its arguments) with one softmax pass over a group
    of heads' stacked f32 scores; the group is the largest power of two
    (up to 8 heads) that fits: 4 in bf16, 2 in f32 at the repro's
    widths."""
    heads = bias.shape[0]
    if x.device.type == "cpu":
        return plain.perhead_qkv_attention(x, wqkv, bias, heads,
                                           wqkv.shape[1] // (3 * heads))
    out = _launch_grouped("stacked_softmax_attention",
                          "vgm_stacked_softmax_attention", x, wqkv, bias,
                          None, 8, 1)
    global stacked_launches
    stacked_launches += 1
    return out


def staged_attention_core(qn: Tensor, kn: Tensor, v: Tensor,
                          bias: Tensor) -> Tensor:
    """R11's core on head-major (heads, Bw, n, dh) ``qn``, ``kn``, ``v`` and
    ``bias`` (heads, n, n) f32; the result is (heads, Bw, n, dh) in v's
    dtype."""
    if qn.device.type == "cpu":
        return plain.staged_headmajor_core(qn, kn, v, bias)
    name = "staged_attention_core"
    _check_cuda(name, qn, 4)
    heads, bw, n, dh = qn.shape
    for what, t in (("kn", kn), ("v", v)):
        _check_operand(name, what, t, qn.shape, qn.dtype, qn.device)
    _check_operand(name, "bias", bias, (heads, n, n), torch.float32,
                   qn.device)
    if not (n <= 64 and dh % 16 == 0 and dh <= 64):
        raise ValueError(f"{name}: n={n} (<= 64) and dim_head={dh} (a "
                         "multiple of 16, <= 64) out of the kernel's range")
    out = torch.empty_like(qn)
    library.check(library.load().vgm_staged_attention_core(
        qn.data_ptr(), kn.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), heads, bw, n, dh, int(qn.dtype == torch.bfloat16),
        library.stream(qn)), name)
    global staged_core_launches
    staged_core_launches += 1
    return out


def staged_attention(x: Tensor, wqkv: Tensor, bias: Tensor) -> Tensor:
    """R11 whole, the arguments of R1: the qkv product with f32 results
    (cuBLAS; ``torch.mm(..., out_dtype=torch.float32)`` for bf16 operands,
    as ``preferred_element_type=f32``), the norm and the head-major layout
    in stock PyTorch, then ``staged_attention_core`` and the layout back."""
    heads = bias.shape[0]
    dh = wqkv.shape[1] // (3 * heads)
    if x.device.type == "cpu":
        return plain.staged_headmajor_attention(x, wqkv, bias, heads, dh)
    _check_cuda("staged_attention", x, 3)
    bw, n, dim = x.shape
    _check_operand("staged_attention", "wqkv", wqkv, (dim, 3 * heads * dh),
                   x.dtype, x.device)
    x2 = x.reshape(bw * n, dim)
    qkv = (torch.mm(x2, wqkv, out_dtype=torch.float32)
           if x.dtype == torch.bfloat16 else torch.mm(x2, wqkv))
    qn, kn, v = plain.stage_headmajor(qkv.reshape(bw, n, -1), heads, dh,
                                      x.dtype)
    return plain.unstage_headmajor(staged_attention_core(qn, kn, v, bias))


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


MAX_GROUP = 8   # heads a group of R3's indicator or of a two-pass stack


def crosshead_norm_attention(x: Tensor, wqkv: Tensor, bias: Tensor,
                             heads_per_group: Optional[int] = None) -> Tensor:
    """R3: R1's function (its arguments) on R4's structure, with each
    group's q and k norms from one product of their squares with a 0/1
    indicator.  Unless given, the group is R4's pick (the largest, up to 2
    heads, of which two CTAs share an SM): 1 head in bf16 at the repro's
    widths, 2 in f32."""
    heads = bias.shape[0]
    if x.device.type == "cpu":
        return plain.perhead_qkv_attention(x, wqkv, bias, heads,
                                           wqkv.shape[1] // (3 * heads))
    if heads_per_group is not None and heads_per_group > MAX_GROUP:
        raise ValueError(f"crosshead_norm_attention: {heads_per_group} heads "
                         f"a group (<= {MAX_GROUP})")
    out = _launch_grouped("crosshead_norm_attention",
                          "vgm_crosshead_norm_attention", x, wqkv, bias,
                          heads_per_group, 2, 2)
    global crosshead_launches
    crosshead_launches += 1
    return out


def _pick_outproj(smem_bytes, dim: int, dh: int, out_dim: int, heads: int,
                  is_bf16: int, two_pass: bool, perhead_wout: bool):
    """(heads a two-pass stack, heads a concat product) of the out-
    projection kernel: the stack the largest power of two up to 2 heads (as
    R4's pick; 0 for one pass), then the concat the largest power of two up
    to every head (0 for a per-head out-projection), that fit one CTA's
    shared memory; None when nothing fits."""
    def fits(group, cat):
        return smem_bytes(dim, dh, out_dim, group, cat, is_bf16) <= MAX_SMEM

    def largest(most, ok):
        v = 1
        while 2 * v <= most:
            v *= 2
        while v and not ok(v):
            v //= 2
        return v

    group = (largest(min(2, heads), lambda g: fits(g, 0 if perhead_wout
                                                   else 1))
             if two_pass else 0)
    if two_pass and not group:
        return None
    if perhead_wout:
        return (group, 0) if fits(group, 0) else None
    cat = largest(heads, lambda c: fits(group, c))
    return (group, cat) if cat else None


def outproj_attention(x: Tensor, w: Tensor, bias: Tensor, wout: Tensor, *,
                      two_pass: bool, perhead_wout: bool,
                      bf16_score: bool = False, bf16_agg: bool = False,
                      windows_per_cta: int = WINDOWS_PER_CTA,
                      out_dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """R12, R13, R2 and R8: R1's attention of (Bw, n, dim) ``x`` with
    ``bias`` (heads, n, n) f32, then the out-projection, as
    ``ops/attention_variants.py::outproj_attention``.  ``w`` is R1's (dim,
    3 * heads * dh) wqkv or R9's (3, heads, dim, dh) ``w4``; ``wout`` is
    (heads * dh, out_dim) or (heads, dh, out_dim).  Each is laid out once
    into the kernel's per-head slices.  ``two_pass``: every head's scores of
    a group first, then one softmax and P.v; ``perhead_wout``: one product
    a head summed in f32, else the concat of the head outputs; the casts as
    R2's; ``windows_per_cta`` as R8's 8 * kfold.  Returns (Bw, n, out_dim)
    in ``out_dtype``."""
    heads = bias.shape[0]
    if w.dim() == 4:
        _, _, dim, dh = w.shape
        wqkv = w.permute(2, 0, 1, 3).reshape(dim, 3 * heads * dh)
        w_heads = w.permute(1, 2, 0, 3).reshape(heads, dim, 3 * dh)
    else:
        dim, dh = w.shape[0], w.shape[1] // (3 * heads)
        wqkv, w_heads = w, None
    if x.device.type == "cpu":
        return plain.outproj_attention(
            x, wqkv, bias, wout, heads, dh, bf16_score=bf16_score,
            bf16_agg=bf16_agg, out_dtype=out_dtype)
    name = "outproj_attention"
    w_heads = (_per_head(w, heads) if w_heads is None
               else w_heads.contiguous())
    bw, n, dim, heads, dh = _check_rows(name, x, w_heads, bias)
    if wout.numel() % (heads * dh):
        raise ValueError(f"{name}: wout {tuple(wout.shape)} is not ({heads} "
                         f"* {dh}, out_dim)")
    wout2 = wout.reshape(heads * dh, -1).contiguous()
    out_dim = wout2.shape[1]
    _check_operand(name, "wout", wout2, (heads * dh, out_dim), x.dtype,
                   x.device)
    if out_dim % 16 or out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: out_dim={out_dim} (a multiple of 16) or "
                         f"out_dtype {out_dtype} (f32 or bf16) out of range")
    if windows_per_cta < 1:
        raise ValueError(f"{name}: windows_per_cta={windows_per_cta} (>= 1)")
    is_bf16 = int(x.dtype == torch.bfloat16)
    lib = library.load()
    picked = _pick_outproj(lib.vgm_outproj_attention_smem_bytes, dim, dh,
                           out_dim, heads, is_bf16, two_pass, perhead_wout)
    if picked is None:
        raise ValueError(f"{name}: dim={dim}, dim_head={dh}, out_dim="
                         f"{out_dim} do not fit in shared memory")
    group, cat = picked
    out = torch.empty(bw, n, out_dim, dtype=out_dtype, device=x.device)
    library.check(lib.vgm_outproj_attention(
        x.data_ptr(), w_heads.data_ptr(), bias.data_ptr(), wout2.data_ptr(),
        out.data_ptr(), bw, n, dim, heads, dh, out_dim, group, cat,
        int(bf16_score), int(bf16_agg), windows_per_cta, is_bf16,
        int(out_dtype == torch.bfloat16), library.stream(x)), name)
    outproj_launches[(two_pass, perhead_wout, bf16_score, bf16_agg,
                      windows_per_cta)] += 1
    return out


def _pick_sub_pack(smem_bytes, dim: int, dh: int, out_dim: int, k_pack: int,
                   two_pass: bool, is_bf16: int) -> int:
    """The most heads of a pack whose q|k|v fit one CTA's shared memory
    beside x, y and the pack's outputs: the largest divisor of ``k_pack``
    that fits (0 when not even one head does)."""
    for sub in range(k_pack, 0, -1):
        if (k_pack % sub == 0 and smem_bytes(dim, dh, out_dim, k_pack, sub,
                                             int(two_pass), is_bf16)
                <= MAX_SMEM):
            return sub
    return 0


def headpack_attention(x: Tensor, w: Tensor, bias: Tensor, wout: Tensor, *,
                       k_pack: int, two_pass: bool,
                       windows_per_cta: int = WINDOWS_PER_CTA,
                       out_dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """R5 (``k_pack`` 2) and R6 (4 and 8): R1's attention of (Bw, n, dim)
    ``x`` with ``bias`` (heads, n, n) f32, then the out-projection, as
    ``ops/attention_variants.py::outproj_attention``, each head shifted by
    its own row max.  ``w`` is R1's (dim, 3 * heads * dh) wqkv or R9's (3,
    heads, dim, dh) ``w4``; ``wout`` is (heads * dh, out_dim) or (heads, dh,
    out_dim).  Each is laid out once into the kernel's per-head slices.
    Each pack of ``k_pack`` consecutive heads takes its q|k|v from one
    product and its share of the out-projection from another; ``two_pass``:
    the pack's scores first, then one softmax and P.v; each CTA runs
    ``windows_per_cta`` windows (the repros' blk).  As many of a pack's
    heads' q|k|v as fit are in shared memory at once (``_pick_sub_pack``).
    Returns (Bw, n, out_dim) in ``out_dtype``."""
    heads = bias.shape[0]
    if w.dim() == 4:
        _, _, dim, dh = w.shape
        wqkv = w.permute(2, 0, 1, 3).reshape(dim, 3 * heads * dh)
        w_heads = w.permute(1, 2, 0, 3).reshape(heads, dim, 3 * dh)
    else:
        dim, dh = w.shape[0], w.shape[1] // (3 * heads)
        wqkv, w_heads = w, None
    if x.device.type == "cpu":
        return plain.outproj_attention(x, wqkv, bias, wout, heads, dh,
                                       out_dtype=out_dtype)
    name = "headpack_attention"
    _check_cuda(name, x, 3)
    if not (1 <= k_pack <= MAX_GROUP and heads % k_pack == 0):
        raise ValueError(f"{name}: k_pack={k_pack} must divide {heads} heads "
                         f"and be <= {MAX_GROUP}")
    w_heads = (_per_head(w, heads) if w_heads is None
               else w_heads.contiguous())
    bw, n, dim, heads, dh = _check_rows(name, x, w_heads, bias)
    if wout.numel() % (heads * dh):
        raise ValueError(f"{name}: wout {tuple(wout.shape)} is not ({heads} "
                         f"* {dh}, out_dim)")
    wout2 = wout.reshape(heads * dh, -1).contiguous()
    out_dim = wout2.shape[1]
    _check_operand(name, "wout", wout2, (heads * dh, out_dim), x.dtype,
                   x.device)
    if out_dim % 16 or out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: out_dim={out_dim} (a multiple of 16) or "
                         f"out_dtype {out_dtype} (f32 or bf16) out of range")
    if windows_per_cta < 1:
        raise ValueError(f"{name}: windows_per_cta={windows_per_cta} (>= 1)")
    is_bf16 = int(x.dtype == torch.bfloat16)
    lib = library.load()
    smem_bytes = lib.vgm_headpack_attention_smem_bytes
    sub_pack = _pick_sub_pack(smem_bytes, dim, dh, out_dim, k_pack, two_pass,
                              is_bf16)
    if not sub_pack:
        raise ValueError(
            f"{name}: {k_pack} heads a pack of dim={dim}, dim_head={dh}, "
            f"out_dim={out_dim} need "
            f"{smem_bytes(dim, dh, out_dim, k_pack, 1, int(two_pass), is_bf16)}"
            f" bytes of shared memory with one head's q|k|v at a time (at "
            f"most {MAX_SMEM})")
    out = torch.empty(bw, n, out_dim, dtype=out_dtype, device=x.device)
    library.check(lib.vgm_headpack_attention(
        x.data_ptr(), w_heads.data_ptr(), bias.data_ptr(), wout2.data_ptr(),
        out.data_ptr(), bw, n, dim, heads, dh, out_dim, k_pack, sub_pack,
        int(two_pass), windows_per_cta, is_bf16,
        int(out_dtype == torch.bfloat16), library.stream(x)), name)
    headpack_launches[(k_pack, two_pass, windows_per_cta)] += 1
    return out
