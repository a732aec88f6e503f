"""The TPU attention repros on the GPU: the wrappers of their hand-written
CUDA kernels under ``csrc/`` and their launch counters.

* ``perhead_attention`` (``perhead_attention.cu``): R1, and R14 at 16
  windows a CTA; in bf16 at dim_head 16 or 32 on warpgroup MMA
  (``perhead_route`` names the design a launch takes);
* ``perhead_weight_attention`` (the same kernel): R9, from its (3, heads,
  dim, dim_head) weight;
* ``headmajor_attention`` (``headmajor_attention.cu``): R4, a group of
  heads on one staged x; in bf16 at dim_head 16 or 32 on the per-head
  kernel's wgmma body (``headmajor_route`` names the design a launch
  takes), else a group's q|k|v at once, then a warp per query row;
* ``stacked_softmax_attention`` (``stacked_softmax_attention.cu``): R10,
  one softmax over a group of heads' stacked scores; in bf16 at K1's strip
  widths on K1's strip body without its out-projection (``stacked_route``
  names the design a launch takes);
* ``staged_attention_core`` (``staged_attention_core.cu``): R11's core on
  head-major operands (in bf16 on a persistent grid with a ring of
  windows, ``staged_core_route``), and ``staged_attention``, R11 whole,
  whose staging around the kernel is stock PyTorch (cuBLAS), as the repro
  leaves it to XLA;
* ``maxvit_layer_attention`` (``maxvit_layer_attention.cu``): R7, one
  MaxViT layer's block and grid attention in one cluster launch, on K1's
  strip body in bf16;
* ``crosshead_norm_attention`` (``crosshead_norm_attention.cu``): R3, R4's
  structure with the q/k norms from one product with a 0/1 indicator; in
  bf16 at dim_head 16 or 32 on the same wgmma body (``crosshead_route``);
* ``outproj_attention`` (``outproj_attention.cu``): R12, R13, R2 and R8,
  R1's function plus the out-projection, with the pass, out-projection,
  cast, windows-a-CTA and n choices at run time; in bf16 at K1's strip
  widths on K1's strip body (``outproj_route`` names the design a launch
  takes);
* ``headpack_attention`` (``headpack_attention.cu``): R5 and R6, the same
  function with a pack of K heads' q|k|v from one product and one
  out-projection a pack; in bf16 at K1's strip widths on the out-projection
  kernel's strip kernel (``headpack_route``).

Each takes the arguments of its plain version in ``ops/attention_variants.py``
(plus the windows a CTA or heads a group, where the kernel has them).  For
a tensor on the CPU it runs that plain version; for a CUDA tensor it
launches the kernel or raises.  The kernels live in the library that
``ops/cuda/library.py`` builds.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
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
# bf16_agg, windows_per_cta), and by the design it took ("first" or
# "strip", as OUTPROJ_ROUTES names the kernel's route)
outproj_launches: Counter = Counter()
outproj_route_launches: Counter = Counter()
OUTPROJ_ROUTES = ("first", "strip")
# R5 and R6's kernel, by (k_pack, two_pass, windows_per_cta), and by the
# design it took; R10's by the design it took (as OUTPROJ_ROUTES names the
# route of each)
headpack_launches: Counter = Counter()
headpack_route_launches: Counter = Counter()
stacked_route_launches: Counter = Counter()
# R1, R14 and R9's kernel by the design it took, as PERHEAD_ROUTES names
# the kernel's route
perhead_route_launches: Counter = Counter()
PERHEAD_ROUTES = ("first", "wgmma")
BIAS_LD = 72                  # floats a bias row the wgmma design reads
# R4's and R3's kernels by the design they took, as PERHEAD_ROUTES names
# the kernels' routes
headmajor_route_launches: Counter = Counter()
crosshead_route_launches: Counter = Counter()
# R11's core by the design it took, as STAGED_ROUTES names the kernel's
# route
staged_core_route_launches: Counter = Counter()
STAGED_ROUTES = ("first", "ring")
WGMMA_GROUP = 2               # R4's and R3's heads a staged x by default

WINDOWS_PER_CTA = 8           # R4, R9 and R10, as R1


def reset_launches() -> None:
    global perhead_weight_launches, headmajor_launches, stacked_launches
    global staged_core_launches, layer_launches, crosshead_launches
    perhead_launches.clear()
    perhead_route_launches.clear()
    headmajor_route_launches.clear()
    crosshead_route_launches.clear()
    staged_core_route_launches.clear()
    outproj_launches.clear()
    outproj_route_launches.clear()
    headpack_launches.clear()
    headpack_route_launches.clear()
    stacked_route_launches.clear()
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


def perhead_route(n: int, dim: int, dh: int, dtype: torch.dtype) -> str:
    """The design a launch of the per-head kernel at these widths takes, as
    the kernel's own ``vgm_perhead_attention_route`` says: "wgmma" (bf16,
    dim_head 16 or 32, dim a multiple of 16 up to 176 at dim_head 32 and
    288 at 16, n <= 64) or "first"."""
    return PERHEAD_ROUTES[library.load().vgm_perhead_attention_route(
        n, dim, dh, int(dtype == torch.bfloat16))]


def _wgmma_operands(w_heads: Tensor, bias: Tensor):
    """The per-head weights (heads, dim, 3 dh) and the bias (heads, n, n)
    in the layouts the wgmma design copies whole, a head at a time: each
    head's Wqkv_h^T (3 dh x dim) as 8 x 8 core matrices, (heads, 3 dh / 8,
    dim / 8, 8, 8), and the bias rows padded to ``BIAS_LD`` floats."""
    heads, dim, qkv = w_heads.shape
    tiles = (w_heads.transpose(1, 2).reshape(heads, qkv // 8, 8, dim // 8, 8)
             .permute(0, 1, 3, 2, 4).contiguous())
    return tiles, F.pad(bias, (0, BIAS_LD - bias.shape[-1])).contiguous()


def _launch_perhead(name: str, x: Tensor, w_heads: Tensor, bias: Tensor,
                    windows_per_cta: int) -> Tensor:
    bw, n, dim, heads, dh = _check_rows(name, x, w_heads, bias)
    if windows_per_cta < 1:
        raise ValueError(f"{name}: windows_per_cta={windows_per_cta} (>= 1)")
    is_bf16 = int(x.dtype == torch.bfloat16)
    lib = library.load()
    route = perhead_route(n, dim, dh, x.dtype)
    out = torch.empty(bw, n, heads * dh, dtype=x.dtype, device=x.device)
    if route == "wgmma":
        tiles, rows = _wgmma_operands(w_heads, bias)
        library.check(lib.vgm_perhead_attention_wgmma(
            x.data_ptr(), tiles.data_ptr(), rows.data_ptr(), out.data_ptr(),
            bw, n, dim, heads, dh, windows_per_cta, library.stream(x)), name)
    else:
        if lib.vgm_perhead_attention_smem_bytes(dim, dh, is_bf16) > MAX_SMEM:
            raise ValueError(f"{name}: dim={dim}, dim_head={dh} do not fit "
                             "in shared memory")
        library.check(lib.vgm_perhead_attention(
            x.data_ptr(), w_heads.data_ptr(), bias.data_ptr(),
            out.data_ptr(), bw, n, dim, heads, dh, windows_per_cta, is_bf16,
            library.stream(x)), name)
    perhead_route_launches[route] += 1
    return out


def perhead_attention(x: Tensor, wqkv: Tensor, bias: Tensor,
                      windows_per_cta: int) -> Tensor:
    """R1's per-head attention of (Bw, n, dim) ``x`` with ``wqkv`` (dim,
    3 * heads * dh) in R1's q | k | v layout and ``bias`` (heads, n, n) f32;
    each CTA runs ``windows_per_cta`` windows (8 is R1, 16 is R14) on the
    design ``perhead_route`` names."""
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
    kernel runs at 8 windows a CTA, as R1's launch: each head's weight slice
    serves the CTA's windows, R9's structure."""
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
                    ctas_per_sm: int, strip: bool = False) -> Tensor:
    """Launch R4's, R3's or R10's kernel (library entry ``entry``),
    ``heads_per_group`` heads a step (default: ``_pick_group``), 8 windows
    a CTA; ``strip``: the launch takes R10's strip design, which reads no
    group, so none is picked (0 is passed)."""
    heads = bias.shape[0]
    w_heads = _per_head(wqkv, heads)
    bw, n, dim, heads, dh = _check_rows(name, x, w_heads, bias)
    is_bf16 = int(x.dtype == torch.bfloat16)
    lib = library.load()
    smem_bytes = getattr(lib, entry + "_smem_bytes")
    if strip:
        group = 0
    else:
        group = heads_per_group or _pick_group(smem_bytes, dim, dh, heads,
                                               is_bf16, most, ctas_per_sm)
        if not (1 <= group <= heads
                and smem_bytes(dim, dh, group, is_bf16) <= MAX_SMEM):
            raise ValueError(f"{name}: {group} heads of dim={dim}, dim_head="
                             f"{dh} a group do not fit in shared memory or "
                             f"{heads} heads")
    out = torch.empty(bw, n, heads * dh, dtype=x.dtype, device=x.device)
    library.check(getattr(lib, entry)(
        x.data_ptr(), w_heads.data_ptr(), bias.data_ptr(), out.data_ptr(), bw,
        n, dim, heads, dh, group, WINDOWS_PER_CTA, is_bf16,
        library.stream(x)), name)
    return out


def grouped_route(entry: str, n: int, dim: int, dh: int, group: int,
                  dtype: torch.dtype) -> str:
    """The design a launch of R4's (``entry`` "vgm_headmajor_attention") or
    R3's ("vgm_crosshead_norm_attention") kernel at these widths and
    ``group`` heads takes, as the kernel's own ``<entry>_route`` says:
    "wgmma" (bf16, dim_head 16 or 32, n <= 64, group 1 or 2, dim a
    multiple of 16 while three head buffers and three warpgroups fit a CTA:
    up to 128 at dim_head 32 and 224 at 16 at every n, more at small n) or
    "first".

    The wrappers' ``heads_per_group`` (G) means what the design makes of
    it: on the wgmma design the heads one staged x of a window serves (1
    or 2, default ``WGMMA_GROUP``); on the first design the heads whose
    q|k|v a step computes at once (up to the heads, R3 up to
    ``MAX_GROUP``; default ``_pick_group``'s).  So G 3 and more always
    takes the first design, and G 2 takes either with the widths; the
    route counters (``headmajor_route_launches``,
    ``crosshead_route_launches``) say which ran."""
    return PERHEAD_ROUTES[getattr(library.load(), entry + "_route")(
        n, dim, dh, group, int(dtype == torch.bfloat16))]


def headmajor_route(n: int, dim: int, dh: int, dtype: torch.dtype,
                    group: int = WGMMA_GROUP) -> str:
    """``grouped_route`` of R4's kernel."""
    return grouped_route("vgm_headmajor_attention", n, dim, dh, group, dtype)


def crosshead_route(n: int, dim: int, dh: int, dtype: torch.dtype,
                    group: int = WGMMA_GROUP) -> str:
    """``grouped_route`` of R3's kernel."""
    return grouped_route("vgm_crosshead_norm_attention", n, dim, dh, group,
                         dtype)


def _launch_grouped_route(name: str, entry: str, x: Tensor, wqkv: Tensor,
                          bias: Tensor, heads_per_group: Optional[int],
                          counter: Counter) -> Tensor:
    """Launch R4's or R3's kernel (library entry ``entry``) on the design
    ``grouped_route`` names: the wgmma design at ``heads_per_group`` heads a
    staged x (default ``WGMMA_GROUP``, at most the heads), else the first
    design at ``heads_per_group`` (default ``_pick_group``'s).  Counts the
    design in ``counter``."""
    _check_cuda(name, x, 3)
    bw, n, dim = x.shape
    heads = bias.shape[0]
    dh = wqkv.shape[1] // (3 * heads)
    group = heads_per_group or min(WGMMA_GROUP, heads)
    route = grouped_route(entry, n, dim, dh, group, x.dtype)
    if route == "wgmma":
        w_heads = _per_head(wqkv, heads)
        _check_rows(name, x, w_heads, bias)
        if group > heads:
            raise ValueError(f"{name}: {group} heads a group of {heads}")
        tiles, rows = _wgmma_operands(w_heads, bias)
        out = torch.empty(bw, n, heads * dh, dtype=x.dtype, device=x.device)
        library.check(getattr(library.load(), entry + "_wgmma")(
            x.data_ptr(), tiles.data_ptr(), rows.data_ptr(), out.data_ptr(),
            bw, n, dim, heads, dh, group, WINDOWS_PER_CTA, library.stream(x)),
            name)
    else:
        out = _launch_grouped(name, entry, x, wqkv, bias, heads_per_group, 2,
                              2)
    counter[route] += 1
    return out


def headmajor_attention(x: Tensor, wqkv: Tensor, bias: Tensor,
                        heads_per_group: Optional[int] = None) -> Tensor:
    """R4: R1's function (its arguments) with a group of heads run on one
    staged x.  In bf16 at the widths ``headmajor_route`` names "wgmma" the
    kernel runs the per-head kernel's wgmma body, ``heads_per_group`` (1 or
    2; default ``WGMMA_GROUP``) heads a staged x, its output bit-identical
    to ``perhead_attention``'s there.  Elsewhere, and at any
    ``heads_per_group`` above 2, the first design: the group's q|k|v
    computed at once and stored head-major, then a warp per query row; its
    group unless given the largest (up to 2 heads) of which two CTAs share
    an SM, 2 in f32.  ``grouped_route`` sets out what G means on each."""
    heads = bias.shape[0]
    if x.device.type == "cpu":
        return plain.perhead_qkv_attention(x, wqkv, bias, heads,
                                           wqkv.shape[1] // (3 * heads))
    out = _launch_grouped_route("headmajor_attention",
                                "vgm_headmajor_attention", x, wqkv, bias,
                                heads_per_group, headmajor_route_launches)
    global headmajor_launches
    headmajor_launches += 1
    return out


def stacked_route(n: int, dim: int, dh: int, dtype: torch.dtype) -> str:
    """The design a launch of R10's kernel at these widths takes, as the
    kernel's own ``vgm_stacked_softmax_attention_route`` says: "strip"
    (bf16, dim and dim_head multiples of 16, dim <= 128, dim_head <= 32)
    or "first"."""
    return OUTPROJ_ROUTES[library.load().vgm_stacked_softmax_attention_route(
        n, dim, dh, int(dtype == torch.bfloat16))]


def stacked_softmax_attention(x: Tensor, wqkv: Tensor,
                              bias: Tensor) -> Tensor:
    """R10: R1's function (its arguments) with one softmax pass over a group
    of heads' stacked f32 scores; the group is the largest power of two
    (up to 8 heads) that fits: 4 in bf16 (off the strip widths), 2 in f32
    at the repro's widths.  In bf16 at K1's strip widths
    (``stacked_route``) the kernel runs K1's strip body without its
    out-projection, where one softmax over a stack is each row's own: no
    group is picked there."""
    heads = bias.shape[0]
    if x.device.type == "cpu":
        return plain.perhead_qkv_attention(x, wqkv, bias, heads,
                                           wqkv.shape[1] // (3 * heads))
    route = stacked_route(x.shape[1], x.shape[-1],
                          wqkv.shape[1] // (3 * heads), x.dtype)
    out = _launch_grouped("stacked_softmax_attention",
                          "vgm_stacked_softmax_attention", x, wqkv, bias,
                          None, 8, 1, route == "strip")
    global stacked_launches
    stacked_launches += 1
    stacked_route_launches[route] += 1
    return out


def staged_core_route(n: int, dh: int, dtype: torch.dtype) -> str:
    """The design a launch of R11's core at these widths takes, as the
    kernel's own ``vgm_staged_attention_core_route`` says: "ring" (bf16,
    n <= 64, dim_head 16, 32, 48 or 64) or "first" (f32)."""
    return STAGED_ROUTES[library.load().vgm_staged_attention_core_route(
        n, dh, int(dtype == torch.bfloat16))]


def staged_core_occupancy(dh: int) -> Tuple[int, int, int, int, int]:
    """The ring design's (registers, local bytes a thread, shared memory a
    CTA, CTAs an SM, windows in the ring) at dim_head ``dh``."""
    out = (ctypes.c_int * 5)()
    if library.load().vgm_staged_attention_core_occupancy(dh, out) != 0:
        raise RuntimeError(f"staged_attention_core: no occupancy at "
                           f"dim_head {dh}")
    return tuple(out)


def staged_attention_core(qn: Tensor, kn: Tensor, v: Tensor,
                          bias: Tensor) -> Tensor:
    """R11's core on head-major (heads, Bw, n, dh) ``qn``, ``kn``, ``v`` and
    ``bias`` (heads, n, n) f32; the result is (heads, Bw, n, dh) in v's
    dtype.  bf16 runs the ring design, f32 the first design
    (``staged_core_route``)."""
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
    if any(t.data_ptr() % 16 for t in (qn, kn, v)):
        raise ValueError(f"{name}: qn, kn and v must be 16-byte aligned")
    route = staged_core_route(n, dh, qn.dtype)
    out = torch.empty_like(qn)
    library.check(library.load().vgm_staged_attention_core(
        qn.data_ptr(), kn.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), heads, bw, n, dh, int(qn.dtype == torch.bfloat16),
        library.stream(qn)), name)
    global staged_core_launches
    staged_core_launches += 1
    staged_core_route_launches[route] += 1
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
                           ops_grid, window_size: int,
                           cluster: Optional[int] = None) -> Tensor:
    """R7: one MaxViT layer's block attention, register mean and grid
    attention of the (S, H, W, dim) maps, with the residuals, in one
    launch; the arguments of ``ops/attention_variants.py::
    maxvit_layer_attention``.  ``cluster``: the CTAs a sample-lead on the
    strip design (bf16, dim and dim_head multiples of 16, dim <= 128,
    dim_head <= 32), a divisor of the window count up to 8; None takes the
    kernel's default.  The strip design keeps the block stage's map in an
    f32 scratch map of x_map's shape, allocated here."""
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
                                              is_bf16, cluster or 0) == 0:
        raise ValueError(f"{name}: map {h}x{w}, window {window_size}, {nr} "
                         f"registers, dim={dim}, dim_head={dh}, cluster "
                         f"{cluster} out of the kernel's range (windows must "
                         "tile the map, a window hold <= 64 tokens, and a "
                         "cluster of <= 16 CTAs hold the map; a cluster size "
                         "is chosen only in bf16 with dim and dim_head "
                         "multiples of 16, dim <= 128, dim_head <= 32, and "
                         "divides the windows, up to 8)")
    scratch = torch.empty(lib.vgm_maxvit_layer_attention_scratch_floats(
        s, h, w, dim, dh, is_bf16), dtype=f32, device=dev)
    out = torch.empty_like(x_map)
    library.check(lib.vgm_maxvit_layer_attention(
        x_map.data_ptr(), regs.data_ptr(),
        *(t.data_ptr() for t in ops_block[:7]),
        *(t.data_ptr() for t in ops_grid[:7]), scratch.data_ptr(),
        out.data_ptr(), s, h, w, window_size, nr, dim, heads, dh, is_bf16,
        cluster or 0, library.stream(x_map)), name)
    global layer_launches
    layer_launches += 1
    return out


MAX_GROUP = 8   # heads a group of R3's indicator or of a two-pass stack


def crosshead_norm_attention(x: Tensor, wqkv: Tensor, bias: Tensor,
                             heads_per_group: Optional[int] = None) -> Tensor:
    """R3: R1's function (its arguments) on R4's structure, with the q and
    k norms from one product of their squares with a 0/1 indicator.  In
    bf16 at the widths ``crosshead_route`` names "wgmma" the kernel runs R4's
    wgmma design with the indicator norm on the tensor cores (one head's
    q|k a product), ``heads_per_group`` (1 or 2; default ``WGMMA_GROUP``)
    heads a staged x.  Elsewhere, and at any ``heads_per_group`` above 2,
    the first design, each group's norms one product; its group unless
    given R4's first-design pick, 2 in f32.  ``grouped_route`` sets out
    what G means on each."""
    heads = bias.shape[0]
    if x.device.type == "cpu":
        return plain.perhead_qkv_attention(x, wqkv, bias, heads,
                                           wqkv.shape[1] // (3 * heads))
    if heads_per_group is not None and heads_per_group > MAX_GROUP:
        raise ValueError(f"crosshead_norm_attention: {heads_per_group} heads "
                         f"a group (<= {MAX_GROUP})")
    out = _launch_grouped_route("crosshead_norm_attention",
                                "vgm_crosshead_norm_attention", x, wqkv,
                                bias, heads_per_group,
                                crosshead_route_launches)
    global crosshead_launches
    crosshead_launches += 1
    return out


def outproj_route(n: int, dim: int, dh: int, out_dim: int,
                  dtype: torch.dtype) -> str:
    """The design a launch of the out-projection kernel at these widths
    takes, as the kernel's own ``vgm_outproj_attention_route`` says:
    "strip" (bf16, dim, dim_head and out_dim multiples of 16, dim <= 128,
    dim_head <= 32, out_dim <= 128) or "first"."""
    return OUTPROJ_ROUTES[library.load().vgm_outproj_attention_route(
        n, dim, dh, out_dim, int(dtype == torch.bfloat16))]


def _pick_outproj(smem_bytes, dim: int, dh: int, out_dim: int, heads: int,
                  is_bf16: int, two_pass: bool, perhead_wout: bool):
    """(heads a two-pass stack, heads a concat product) of the out-
    projection kernel's first design: the stack the largest power of two up
    to 2 heads (as R4's pick; 0 for one pass), then the concat the largest
    power of two up to every head (0 for a per-head out-projection), that
    fit one CTA's shared memory; None when nothing fits."""
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
    R2's; ``windows_per_cta`` as R8's 8 * kfold.  In bf16 at K1's strip
    widths (``outproj_route``) the kernel runs K1's strip body, where the
    two structures are one computation: ``two_pass`` and ``perhead_wout``
    then pick nothing, and are still counted.  Returns (Bw, n, out_dim) in
    ``out_dtype``."""
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
    route = outproj_route(n, dim, dh, out_dim, x.dtype)
    if route == "strip":
        group = cat = 0   # the strip design reads neither
    else:
        picked = _pick_outproj(lib.vgm_outproj_attention_smem_bytes, dim,
                               dh, out_dim, heads, is_bf16, two_pass,
                               perhead_wout)
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
    outproj_route_launches[route] += 1
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


def headpack_route(n: int, dim: int, dh: int, out_dim: int,
                   dtype: torch.dtype) -> str:
    """The design a launch of the head-pack kernel at these widths takes,
    as the kernel's own ``vgm_headpack_attention_route`` says: "strip" (the
    out-projection kernel's strip kernel: bf16, dim, dim_head and out_dim
    multiples of 16, dim <= 128, dim_head <= 32, out_dim <= 128) or
    "first"."""
    return OUTPROJ_ROUTES[library.load().vgm_headpack_attention_route(
        n, dim, dh, out_dim, int(dtype == torch.bfloat16))]


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
    In bf16 at K1's strip widths (``headpack_route``) the kernel launches
    the out-projection kernel's strip kernel, whose output is bit-identical
    to ``outproj_attention``'s at any windows a CTA: ``k_pack`` and
    ``two_pass`` then pick nothing, and are still checked and counted.
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
    route = headpack_route(n, dim, dh, out_dim, x.dtype)
    smem_bytes = lib.vgm_headpack_attention_smem_bytes
    sub_pack = (0 if route == "strip" else   # the strip design reads none
                _pick_sub_pack(smem_bytes, dim, dh, out_dim, k_pack,
                               two_pass, is_bf16))
    if route == "first" and not sub_pack:
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
    headpack_route_launches[route] += 1
    return out
