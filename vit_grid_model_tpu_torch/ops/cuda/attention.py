"""Fused window attention on the GPU: the wrappers of the hand-written CUDA
kernels under ``csrc/``, their ctypes binding and their launch counters.

* ``window_attention_fwd.cu`` (K1, the forward, with in-kernel dropout);
* ``window_attention_bwd.cu`` (K3, the backward, with the same dropout
  mask regenerated from the seed);
* ``window_attention_wgrad.cu`` (K3-w: on K3's bf16 tensor-core path, the
  weight gradients dWqkv and dWout from the operands K3 writes);
* ``dropout_keep_mask.cu`` (K1-d alone: writes the keep mask, so that the
  card can compare it with ``ops/dropout.py::keep_mask``; on the CPU
  ``dropout_keep_mask`` is that plain version).

``window_attention`` takes the arguments of the plain version
``ops.attention.attention`` plus a dropout seed and rate.  For a tensor on
the CPU it runs that plain version, with ``ops/dropout.py::keep_mask`` as
its mask when the rate is above 0; for a CUDA tensor it runs
``WindowAttentionFn`` (K1 forward, K3 backward) or raises.  There is no
fallback from one to the other, so both devices draw the same masks from
the same seed.

The kernels live in the library that ``ops/cuda/library.py`` builds from
``csrc/`` at first use.
"""

from __future__ import annotations

from collections import Counter
from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from vit_grid_model_tpu_torch.ops import nn as vnn
from vit_grid_model_tpu_torch.ops.attention import (Attention, attention,
                                                    attention_core)
from vit_grid_model_tpu_torch.ops.cuda import library
from vit_grid_model_tpu_torch.ops.dropout import keep_constants, keep_mask

MAX_TOKENS = 64
MAX_DIM = 256
MAX_DIM_HEAD = 64
BWD_MAX_DIM = 128
MAX_SMEM = 232448

# Kernel launches since the counts were last set to 0, one count per
# kernel.  Only the launches below add to them.
launches = 0          # K1, the forward
bwd_launches = 0      # K3, the backward
wgrad_launches = 0    # K3-w, the weight gradients of K3's tensor-core path
# K1 and K3 launches with dropout on: each evaluates the keep hash of
# csrc/dropout_hash.cuh (K1-d) inline for every score
hash_launches = 0
mask_launches = 0     # the standalone keep-mask kernel
# its launches by the design they took, as MASK_ROUTES names the kernel's
# route
mask_route_launches: Counter = Counter()
MASK_ROUTES = ("chunks",)
# K1's launches by the design they took, as FWD_ROUTES names the kernel's
# route (``fwd_route``)
fwd_route_launches: Counter = Counter()
FWD_ROUTES = ("first", "strip")


def reset_launches() -> None:
    global launches, bwd_launches, wgrad_launches, hash_launches
    global mask_launches
    launches = bwd_launches = wgrad_launches = hash_launches = 0
    mask_launches = 0
    mask_route_launches.clear()
    fwd_route_launches.clear()


# ---------------------------------------------------------------------------
# the kernels' inputs, built with differentiable torch ops
# ---------------------------------------------------------------------------


class KernelInputs(NamedTuple):
    """What K1 and K3 take besides x.  gamma/beta: per-sample FiLM terms,
    or the LN affine of an unconditioned layer (one row), f32 after
    rounding to x's dtype, used when ``has_film``; wqkv (heads, dim, 3*dh)
    and wout (heads, dh, dim) in x's dtype; qg, kg (heads, dh) and the
    gathered rel-pos bias (heads, n, n) f32."""
    gamma: Tensor
    beta: Tensor
    wqkv: Tensor
    wout: Tensor
    qg: Tensor
    kg: Tensor
    bias: Tensor
    windows_per_sample: int
    has_film: bool


def kernel_inputs(p: Attention, x: Tensor, cond: Optional[Tensor],
                  bias_indices: Tensor,
                  windows_per_sample: int) -> KernelInputs:
    bw, _, dim = x.shape
    heads, dh = p.heads, p.dim_head
    if p.film is not None and cond is not None:
        gamma, beta = p.film(cond)
        wps, has_film = windows_per_sample, True
    elif p.norm.weight is not None:
        gamma, beta = p.norm.weight[None], p.norm.bias[None]
        wps, has_film = bw, True
    else:
        gamma = beta = torch.empty(0, dim, device=x.device)
        wps, has_film = bw, False
    if has_film and gamma.shape[0] * wps != bw:
        raise ValueError(f"{gamma.shape[0]} FiLM rows x {wps} windows "
                         f"per sample != {bw} windows")

    def prep(t):
        return t.to(x.dtype).float().contiguous()

    bias = (vnn.embedding(p.rel_pos_bias.weight, bias_indices.to(x.device))
            .permute(2, 0, 1).float().contiguous())               # (h, n, n)
    # per-head weight slices: (heads, dim, 3*dh) and (heads, dh, dim)
    wqkv = (p.to_qkv.weight.to(x.dtype).reshape(3, heads, dh, dim)
            .permute(1, 3, 0, 2).reshape(heads, dim, 3 * dh).contiguous())
    wout = (p.to_out[0].weight.to(x.dtype).t().reshape(heads, dh, dim)
            .contiguous())
    qg = p.q_norm.gamma.reshape(heads, dh).float().contiguous()
    kg = p.k_norm.gamma.reshape(heads, dh).float().contiguous()
    return KernelInputs(prep(gamma), prep(beta), wqkv, wout, qg, kg, bias,
                        wps, has_film)


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def fwd_route(dim: int, dh: int, dtype: torch.dtype) -> str:
    """The design K1 takes at these widths, as the kernel names it:
    "strip" (bf16 at the strip path's widths) or "first".  Asked once per
    (dim, dh, dtype): a launch pays a lookup, not a foreign call."""
    return FWD_ROUTES[library.load().vgm_window_attention_fwd_route(
        int(dtype == torch.bfloat16), dim, dh)]


def window_attention_fwd(x: Tensor, k: KernelInputs, seed: int,
                         rate: float) -> Tensor:
    """K1 on its own inputs: (Bw, n, dim) in x's dtype."""
    threshold, scale = keep_constants(rate)
    bw, n, dim = x.shape
    heads, _, three_dh = k.wqkv.shape
    out = torch.empty_like(x)
    library.check(library.load().vgm_window_attention_fwd(
        x.data_ptr(), k.gamma.data_ptr(), k.beta.data_ptr(),
        k.wqkv.data_ptr(), k.qg.data_ptr(), k.kg.data_ptr(),
        k.wout.data_ptr(), k.bias.data_ptr(), out.data_ptr(), bw, n, dim,
        heads, three_dh // 3, k.windows_per_sample, int(k.has_film),
        int(x.dtype == torch.bfloat16), seed, threshold, scale,
        library.stream(x)),
        "window_attention_fwd")
    global launches, hash_launches
    launches += 1
    hash_launches += int(threshold != 0)
    fwd_route_launches[fwd_route(dim, three_dh // 3, x.dtype)] += 1
    return out


class WgradOperands(NamedTuple):
    """What K3's tensor-core path writes for K3-w: the T-rounded operands
    of the weight-gradient products, rows < n of every window (R = Bw * n
    rows), bf16: xf (R, dim), dqkv = dQ|dK|dV (R, heads * 3dh) and o (R,
    heads * dh), head h at columns h * 3dh and h * dh."""
    xf: Tensor
    dqkv: Tensor
    o: Tensor


def window_attention_bwd_kernel(x: Tensor, k: KernelInputs, dy: Tensor,
                                seed: int, rate: float
                                ) -> Tuple[Tuple[Tensor, ...],
                                           Optional[WgradOperands]]:
    """K3 alone: ((dx, dgamma_w, dbeta_w, grads), operands).  grads is
    f32 (dwqkv | dwout | dqg | dkg | dbias | padding); on the tensor-core
    path (bf16, dim and dh multiples of 16) K3 leaves its dwqkv | dwout
    block to K3-w and returns the operands K3-w takes, else None."""
    threshold, scale = keep_constants(rate)
    bw, n, dim = x.shape
    heads, _, three_dh = k.wqkv.shape
    dh = three_dh // 3
    is_bf16 = int(x.dtype == torch.bfloat16)
    lib = library.load()
    floats = lib.vgm_window_attention_bwd_slot_floats(n, dim, heads, dh,
                                                      is_bf16)
    # one CTA (and one f32 gradient slot) per SM; each CTA walks a
    # contiguous chunk of windows
    num_slots = min(bw, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    slots = torch.empty(num_slots, floats, device=x.device)
    grads = torch.empty(lib.vgm_window_attention_bwd_grad_floats(
        n, dim, heads, dh), device=x.device)
    scratch = torch.empty(lib.vgm_window_attention_bwd_scratch_elems(
        bw, n, dim, heads, dh, is_bf16), dtype=torch.bfloat16,
        device=x.device)
    dx = torch.empty_like(x)
    dgw = torch.empty(bw, dim, device=x.device)
    dbw = torch.empty(bw, dim, device=x.device)
    library.check(lib.vgm_window_attention_bwd(
        x.data_ptr(), k.gamma.data_ptr(), k.beta.data_ptr(),
        k.wqkv.data_ptr(), k.qg.data_ptr(), k.kg.data_ptr(),
        k.wout.data_ptr(), k.bias.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dgw.data_ptr(), dbw.data_ptr(), grads.data_ptr(), slots.data_ptr(),
        scratch.data_ptr(), bw, n, dim, heads, dh, k.windows_per_sample,
        int(k.has_film), is_bf16, num_slots, seed, threshold, scale,
        library.stream(x)), "window_attention_bwd")
    global bwd_launches, hash_launches
    bwd_launches += 1
    hash_launches += int(threshold != 0)
    operands = None
    if scratch.numel():
        rows = bw * n
        xf, dqkv, o = scratch.split([rows * dim, rows * heads * three_dh,
                                     rows * heads * dh])
        operands = WgradOperands(xf.view(rows, dim), dqkv.view(rows, -1),
                                 o.view(rows, -1))
    return (dx, dgw, dbw, grads), operands


def window_attention_wgrad(ops: WgradOperands, dy: Tensor, heads: int,
                           out: Optional[Tensor] = None
                           ) -> Tuple[Tensor, Tensor]:
    """K3-w: (dwqkv (heads, dim, 3dh), dwout (heads, dh, dim)) f32 from
    K3's operands and dy (R, dim) in bf16, into ``out`` (f32, at least
    4 * heads * dim * dh, contiguous) when given.  For CPU tensors its
    plain version."""
    rows, dim = ops.xf.shape
    dh = ops.o.shape[1] // heads
    if ops.xf.device.type == "cpu":
        return window_attention_wgrad_reference(ops, dy, heads)
    for t in (*ops, dy):
        if t.device.type != "cuda" or t.dtype != torch.bfloat16 or not (
                t.is_contiguous()):
            raise ValueError("window_attention_wgrad: contiguous bf16 CUDA "
                             "tensors only")
    if dim % 16 or dh % 16 or ops.dqkv.shape != (rows, 3 * heads * dh) or (
            ops.o.shape != (rows, heads * dh) or dy.shape != (rows, dim)):
        raise ValueError(f"window_attention_wgrad: shapes {ops.xf.shape}, "
                         f"{ops.dqkv.shape}, {ops.o.shape}, {dy.shape} for "
                         f"{heads} heads")
    lib = library.load()
    size = 4 * heads * dim * dh
    if out is None:
        out = torch.empty(size, device=dy.device)
    partials = torch.empty(lib.vgm_window_attention_wgrad_partial_floats(
        rows, dim, heads, dh), device=dy.device)
    library.check(lib.vgm_window_attention_wgrad(
        ops.xf.data_ptr(), ops.dqkv.data_ptr(), ops.o.data_ptr(),
        dy.data_ptr(), out.data_ptr(), partials.data_ptr(), rows, dim, heads,
        dh, library.stream(dy)), "window_attention_wgrad")
    global wgrad_launches
    wgrad_launches += 1
    dwqkv, dwout = out[:size].split([3 * heads * dim * dh, heads * dh * dim])
    return dwqkv.view(heads, dim, 3 * dh), dwout.view(heads, dh, dim)


def window_attention_bwd(x: Tensor, k: KernelInputs, dy: Tensor, seed: int,
                         rate: float) -> Tuple[Tensor, ...]:
    """K3, and K3-w on its tensor-core path: (dx, dgamma_w, dbeta_w,
    dwqkv, dwout, dqg, dkg, dbias) with per-window dgamma_w/dbeta_w (Bw,
    dim) and f32 weight grads in the layouts of ``KernelInputs``."""
    bw, n, dim = x.shape
    heads, _, three_dh = k.wqkv.shape
    dh = three_dh // 3
    (dx, dgw, dbw, grads), operands = window_attention_bwd_kernel(
        x, k, dy, seed, rate)
    if operands is not None:
        window_attention_wgrad(operands, dy.view(bw * n, dim), heads,
                               out=grads)
    sizes = [heads * dim * three_dh, heads * dh * dim, heads * dh,
             heads * dh, heads * n * n]
    dwqkv, dwout, dqg, dkg, dbias = grads[:sum(sizes)].split(sizes)
    return (dx, dgw, dbw, dwqkv.view(heads, dim, three_dh),
            dwout.view(heads, dh, dim), dqg.view(heads, dh),
            dkg.view(heads, dh), dbias.view(heads, n, n))


def dropout_keep_mask(seed: int, bw: int, heads: int, n: int, rate: float,
                      device: torch.device) -> Tensor:
    """The keep mask of ``ops/dropout.py::keep_mask``, written on the card
    by the kernel that evaluates the attention kernels' hash (on the CPU,
    that plain version)."""
    device = torch.device(device)
    if device.type == "cpu":
        return keep_mask(seed, bw, heads, n, rate, device=device)
    if device.type != "cuda":
        raise ValueError(f"dropout_keep_mask: no kernel for {device}")
    if not (0 < n <= 16384 and bw * heads < 2 ** 31):
        raise ValueError(f"dropout_keep_mask: n={n} (1..16384), Bw={bw} x "
                         f"heads={heads} (< 2**31) out of the kernel's range")
    threshold, scale = keep_constants(rate)
    out = torch.empty(bw, heads, n, n, device=device)
    lib = library.load()
    library.check(lib.vgm_dropout_keep_mask(
        out.data_ptr(), bw, heads, n, seed, threshold, scale,
        library.stream(out)),
        "dropout_keep_mask")
    global mask_launches
    mask_launches += 1
    mask_route_launches[MASK_ROUTES[lib.vgm_dropout_keep_mask_route()]] += 1
    return out


class WindowAttentionFn(torch.autograd.Function):
    """K1 forward and K3 backward.  The forward saves its inputs, not P:
    the backward recomputes the forward inside K3.  The grads come back in
    the layouts of the inputs; autograd carries them through the
    relayouts, the FiLM linear and the bias gather of ``kernel_inputs``."""

    @staticmethod
    def forward(ctx, x, gamma, beta, wqkv, wout, qg, kg, bias,
                windows_per_sample, has_film, seed, rate):
        k = KernelInputs(gamma, beta, wqkv, wout, qg, kg, bias,
                         windows_per_sample, has_film)
        ctx.save_for_backward(x, gamma, beta, wqkv, wout, qg, kg, bias)
        ctx.conf = (windows_per_sample, has_film, seed, rate)
        return window_attention_fwd(x, k, seed, rate)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, wqkv, wout, qg, kg, bias = ctx.saved_tensors
        wps, has_film, seed, rate = ctx.conf
        k = KernelInputs(gamma, beta, wqkv, wout, qg, kg, bias, wps,
                         has_film)
        dx, dgw, dbw, dwqkv, dwout, dqg, dkg, dbias = window_attention_bwd(
            x, k, dy.contiguous(), seed, rate)
        dgamma = dbeta = None
        if has_film:
            # each sample's windows share its gamma/beta row
            dgamma = dgw.reshape(gamma.shape[0], -1, dgw.shape[1]).sum(1)
            dbeta = dbw.reshape(beta.shape[0], -1, dbw.shape[1]).sum(1)
        return (dx, dgamma, dbeta, dwqkv.to(wqkv.dtype),
                dwout.to(wout.dtype), dqg, dkg, dbias, None, None, None,
                None)


def window_attention(p: Attention, x: Tensor, cond: Optional[Tensor],
                     bias_indices: Tensor, *, windows_per_sample: int,
                     seed: Optional[int] = None,
                     dropout_rate: float = 0.0) -> Tensor:
    """The fused attention of ``ops.attention.attention`` on (Bw, n, dim)
    window tokens, with attention dropout at ``dropout_rate`` drawn by the
    counter hash from ``seed`` (an int32: a rank's offset seed may be
    negative, ``models/metnet3.py::rank_seed``)."""
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("window_attention: dropout needs a seed")
    seed = 0 if seed is None else int(seed)
    if x.device.type == "cpu":
        mask = (keep_mask(seed, x.shape[0], p.heads, x.shape[1],
                          dropout_rate) if dropout_rate > 0.0 else None)
        return attention(p, x, cond, bias_indices,
                         windows_per_sample=windows_per_sample,
                         dropout_mask=mask)
    if x.device.type != "cuda":
        raise ValueError(f"window_attention: no kernel for {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"window_attention: dtype {x.dtype} not supported")
    if x.dim() != 3:
        raise ValueError(f"window_attention: x must be (Bw, n, dim), "
                         f"got {tuple(x.shape)}")
    _, n, dim = x.shape
    dh = p.dim_head
    if not (1 <= n <= MAX_TOKENS and dim <= MAX_DIM and dh <= MAX_DIM_HEAD):
        raise ValueError(f"window_attention: n={n} (<= {MAX_TOKENS}), "
                         f"dim={dim} (<= {MAX_DIM}), dim_head={dh} "
                         f"(<= {MAX_DIM_HEAD}) out of the kernel's range")
    if p.to_qkv.weight.device != x.device:
        raise ValueError("window_attention: weights and x on other devices")
    k = kernel_inputs(p, x, cond, bias_indices, windows_per_sample)
    if torch.is_grad_enabled() and (x.requires_grad or any(
            t.requires_grad for t in k[:7])):
        smem = library.load().vgm_window_attention_bwd_smem_bytes(
            dim, dh, int(x.dtype == torch.bfloat16))
        if dim > BWD_MAX_DIM or smem > MAX_SMEM:
            raise ValueError(f"window_attention: the backward kernel takes "
                             f"dim <= {BWD_MAX_DIM} and fitting dim_head; "
                             f"got dim={dim}, dim_head={dh}")
    return WindowAttentionFn.apply(x.contiguous(), *k, seed, dropout_rate)


# ---------------------------------------------------------------------------
# the plain versions the card holds the kernels against
# ---------------------------------------------------------------------------


def window_attention_bwd_reference(x: Tensor, k: KernelInputs, dy: Tensor,
                                   seed: int, rate: float
                                   ) -> Tuple[Tensor, ...]:
    """The plain version of K3: its output tuple (dx, dgamma_w, dbeta_w,
    dwqkv, dwout, dqg, dkg, dbias) by ``torch.autograd.grad`` through the
    plain forward with the same keep mask.  dgamma_w/dbeta_w are per
    window (zero without FiLM), the rest in the layouts of ``k``."""
    bw, _, dim = x.shape
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in
                  (x, k.wqkv, k.wout, k.qg, k.kg, k.bias)]
        xl, wqkv, wout, qg, kg, bias = leaves
        if k.has_film:
            gamma = (k.gamma.detach().repeat_interleave(k.windows_per_sample,
                                                        dim=0)
                     .requires_grad_())
            beta = (k.beta.detach().repeat_interleave(k.windows_per_sample,
                                                      dim=0)
                    .requires_grad_())
            leaves[1:1] = [gamma, beta]
        else:
            gamma = beta = k.gamma
        mask = (keep_mask(seed, bw, k.wqkv.shape[0], x.shape[1], rate,
                          device=x.device) if rate > 0.0 else None)
        out = attention_core(xl, gamma, beta, wqkv, wout, qg, kg, bias,
                             windows_per_sample=1, has_film=k.has_film,
                             dropout_mask=mask)
        grads = torch.autograd.grad(out, leaves, dy)
    if k.has_film:
        dx, dgw, dbw, *rest = grads
    else:
        dx, *rest = grads
        dgw = dbw = torch.zeros(bw, dim, device=x.device)
    dwqkv, dwout, dqg, dkg, dbias = rest
    return (dx, dgw.float(), dbw.float(), dwqkv.float(), dwout.float(),
            dqg, dkg, dbias)


def window_attention_wgrad_reference(ops: WgradOperands, dy: Tensor,
                                     heads: int) -> Tuple[Tensor, Tensor]:
    """The plain version of K3-w: (dwqkv (heads, dim, 3dh), dwout (heads,
    dh, dim)) summed over the rows in f32."""
    rows = ops.xf.shape[0]
    dwqkv = torch.einsum("rc,rhe->hce", ops.xf.float(),
                         ops.dqkv.float().view(rows, heads, -1))
    dwout = torch.einsum("rhd,rc->hdc", ops.o.float().view(rows, heads, -1),
                         dy.float())
    return dwqkv, dwout


def window_attention_bwd_operands_reference(x: Tensor, k: KernelInputs,
                                            dy: Tensor, seed: int,
                                            rate: float) -> WgradOperands:
    """The plain version of the operands K3's tensor-core path writes for
    K3-w, in x's dtype, by autograd through the plain forward with the same
    keep mask: xf and O as the forward computes them, dQ|dK|dV as the
    gradient of its q|k|v."""
    bw, n, dim = x.shape
    heads = k.wqkv.shape[0]
    taps = {}
    with torch.enable_grad():
        wqkv = k.wqkv.detach().requires_grad_()
        mask = (keep_mask(seed, bw, heads, n, rate, device=x.device)
                if rate > 0.0 else None)
        out = attention_core(x.detach(), k.gamma, k.beta, wqkv, k.wout,
                             k.qg, k.kg, k.bias,
                             windows_per_sample=k.windows_per_sample,
                             has_film=k.has_film, dropout_mask=mask,
                             taps=taps)
        (dqkv,) = torch.autograd.grad(out, taps["qkv"], dy)

    def rows(t):  # (Bw, heads, n, e) -> (Bw * n, heads * e)
        return t.detach().transpose(1, 2).reshape(bw * n, -1)

    return WgradOperands(taps["xf"].detach().reshape(bw * n, dim),
                         rows(dqkv), rows(taps["o"]))
