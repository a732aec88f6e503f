"""Plain PyTorch versions of the TPU attention repros, the references that
the CUDA kernels of ``ops/cuda/attention_variants.py`` are held against and
what those wrappers run for tensors on the CPU.

* ``perhead_qkv_attention``: R1's function
  (``benchmarks/mosaic_repros/repro_baseline_perhead.py:22-50``): per head,
  l2-normalized q and k from one qkv product, bias, softmax, P.v; no
  LayerNorm, FiLM, q/k gain or out-projection, no mask.  R14
  (``repro_16window_tile.py``, R1 at 16 windows a program), R4
  (``repro_headmajor_batched.py``), R9 (``repro_perhead_weight_gemm.py``)
  and R10 (``repro_stacked_softmax.py``) compute the same function.
* ``staged_headmajor_attention``: R11
  (``repro_staged_headmajor.py:58-80``), R1's function with the repro's
  rounding points: the qkv product, the l2 norm and a head-major layout
  (``stage_headmajor``) outside the core, q, k and v cast to x's dtype,
  then ``staged_headmajor_core`` (``:31-47``), whose P is cast to v's dtype
  before P.v.  In f32 it equals ``perhead_qkv_attention``.
* ``maxvit_layer_attention``: R7's function
  (``repro_megakernel.py:191-230``), one MaxViT layer's block attention,
  register mean and grid attention, built from ``ops/attention.py::
  attention_core`` and ``ops/window.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from vit_grid_model_tpu_torch.ops.attention import attention_core
from vit_grid_model_tpu_torch.ops.window import (block_partition,
                                                 block_reverse,
                                                 grid_partition, grid_reverse)


def perhead_qkv_attention(x: Tensor, wqkv: Tensor, bias: Tensor, heads: int,
                          dim_head: int) -> Tensor:
    """x (Bw, n, dim); wqkv (dim, 3 * heads * dim_head), q | k | v column
    blocks, each head-major; bias (heads, n, n) f32.  Returns (Bw, n,
    heads * dim_head) in x's dtype: head h's columns are
    ``softmax(l2n(x Wq_h) l2n(x Wk_h)^T + bias_h) (x Wv_h)`` with
    ``l2n(q) = q * rsqrt(max(sum q^2, 1e-24))``.  The qkv product sums in
    f32, and everything after it is f32."""
    bw, n, _ = x.shape
    qkv = torch.matmul(x.float(), wqkv.float())

    def heads_of(t):
        return t.reshape(bw, n, heads, dim_head).transpose(1, 2)

    q, k, v = map(heads_of, qkv.chunk(3, dim=-1))
    q = q * torch.rsqrt(q.square().sum(-1, keepdim=True).clamp(min=1e-24))
    k = k * torch.rsqrt(k.square().sum(-1, keepdim=True).clamp(min=1e-24))
    attn = (torch.matmul(q, k.transpose(-1, -2)) + bias.float()).softmax(-1)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(bw, n, -1)
    return out.to(x.dtype)


def stage_headmajor(qkv: Tensor, heads: int, dim_head: int,
                    dtype: torch.dtype) -> Tuple[Tensor, Tensor, Tensor]:
    """R11's staging: qkv (Bw, n, 3 * heads * dim_head) f32 to l2-normalized
    q and k, and v, each (heads, Bw, n, dim_head) in ``dtype``."""
    bw, n, _ = qkv.shape
    q, k, v = qkv.reshape(bw, n, 3, heads, dim_head).permute(2, 3, 0, 1, 4)
    q = q * torch.rsqrt(q.square().sum(-1, keepdim=True).clamp(min=1e-24))
    k = k * torch.rsqrt(k.square().sum(-1, keepdim=True).clamp(min=1e-24))
    return (q.to(dtype).contiguous(), k.to(dtype).contiguous(),
            v.to(dtype).contiguous())


def unstage_headmajor(out: Tensor) -> Tensor:
    """(heads, Bw, n, dim_head) back to (Bw, n, heads * dim_head)."""
    heads, bw, n, dh = out.shape
    return out.permute(1, 2, 0, 3).reshape(bw, n, heads * dh)


def staged_headmajor_core(qn: Tensor, kn: Tensor, v: Tensor,
                          bias: Tensor) -> Tensor:
    """R11's core on head-major (heads, Bw, n, dim_head) operands and bias
    (heads, n, n) f32: softmax(qn kn^T + bias_h), rounded to v's dtype,
    times v.  Both products sum in f32; the result is in v's dtype."""
    s = torch.matmul(qn.float(), kn.float().transpose(-1, -2))
    attn = (s + bias.float()[:, None]).softmax(-1)
    return torch.matmul(attn.to(v.dtype).float(), v.float()).to(v.dtype)


def staged_headmajor_attention(x: Tensor, wqkv: Tensor, bias: Tensor,
                               heads: int, dim_head: int) -> Tensor:
    """R11 whole: the arguments and result of ``perhead_qkv_attention``.
    The qkv product has f32 results from x's dtype; q, k and v are staged
    head-major in x's dtype, the core runs, and its result is laid back."""
    qkv = torch.matmul(x.float(), wqkv.float())
    qn, kn, v = stage_headmajor(qkv, heads, dim_head, x.dtype)
    return unstage_headmajor(staged_headmajor_core(qn, kn, v, bias))


def maxvit_layer_attention(x_map: Tensor, regs: Tensor, ops_block,
                           ops_grid, window_size: int) -> Tensor:
    """x_map (S, H, W, dim), one map per sample-lead; regs (nr, dim) in
    x_map's dtype; ``ops_block``/``ops_grid``: each attention's kernel
    operands (``ops/cuda/attention.py::KernelInputs``: FiLM gamma/beta
    (S, dim) f32 rounded to x_map's dtype, wqkv (heads, dim, 3dh), wout
    (heads, dh, dim), qg/kg (heads, dh), bias (heads, n, n) gathered for
    the n = nr + window_size^2 real tokens).  Returns (S, H, W, dim) in
    x_map's dtype.

    The residuals and the register mean run in f32 and the result is
    rounded once, as on the TPU.  Each attention runs on the n real tokens,
    which equals the TPU's 64 padded rows with -1e30 on the padded keys; it
    keeps the normalized x and P.v in f32, where the kernels round them to
    bf16 for bf16 inputs."""
    s, _, _, c = x_map.shape
    nr = regs.shape[0]

    def attend(tokens, ops, windows):
        return tokens + attention_core(
            tokens, ops.gamma, ops.beta, ops.wqkv.float(), ops.wout.float(),
            ops.qg, ops.kg, ops.bias, windows_per_sample=windows,
            has_film=True)

    xb, dims = block_partition(x_map.float(), window_size)
    nwin = dims[1] * dims[2]
    r = regs.float().expand(xb.shape[0], nr, c)
    tokens = attend(torch.cat([r, xb], dim=1), ops_block, nwin)
    r2 = tokens[:, :nr].reshape(s, nwin, nr, c).mean(dim=1)
    xg, dims = grid_partition(block_reverse(tokens[:, nr:], window_size,
                                            dims), window_size)
    tokens = attend(torch.cat([r2.repeat_interleave(nwin, dim=0), xg], dim=1),
                    ops_grid, nwin)
    return grid_reverse(tokens[:, nr:], window_size, dims).to(x_map.dtype)
